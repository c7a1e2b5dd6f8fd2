"""Port parity, live telemetry (`repro_torch.serve.telemetry`): the
Prometheus text of the port's registry byte for byte against JAX's for the
same series, `_COUNTER_KEYS`, the key sets of `engine_sample` /
`router_sample` and of `ServeMetrics.report()` against JAX's (slab and
paged: the report-key repair), the JSONL snapshots and the cadence thread,
and the HTTP endpoint scraped on 127.0.0.1 at an ephemeral port."""

import json
import urllib.error
import urllib.request

import pytest

from torch_serve_parity import (DANUBE, NEMOTRON, J, P, engines, jobs,
                                models, needs_jax, serve)
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.serve import telemetry as PT


def _fill(pkg, process_index=None):
    reg = pkg.TelemetryRegistry(prefix="t", process_index=process_index)
    reg.counter("toks", help="tokens so far").set(42)
    reg.counter("steps").inc(3)
    reg.gauge("depth").set(3.5)
    reg.gauge("7bad-name").set(-1e-7)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


@needs_jax
@pytest.mark.parametrize("process_index", [None, 3])
def test_prometheus_text_equals_jax(process_index):
    """The same series render to the same bytes, and snapshot to the same
    scalars, with and without the process label."""
    mine, theirs = _fill(P, process_index), _fill(J, process_index)
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.snapshot() == theirs.snapshot()
    text = mine.render_prometheus()
    assert "# TYPE t_toks counter" in text
    assert 't_lat_bucket{le="+Inf"} 3' in text or \
        't_lat_bucket{process_index="3",le="+Inf"} 3' in text
    with pytest.raises(AssertionError):
        mine.gauge("toks")                 # a kind mismatch refuses


@needs_jax
def test_counter_keys_equal_jax():
    from repro.serve import telemetry as JT
    assert PT._COUNTER_KEYS == JT._COUNTER_KEYS


@needs_jax
@pytest.mark.parametrize("arch,page_size", [(DANUBE, None),
                                            (NEMOTRON, 8)])
def test_report_and_sample_keys_equal_jax(arch, page_size):
    """The port's report() key set equals JAX's (gather_bytes_avoided,
    failovers and trace_dropped included), slab and paged, and so do
    engine_sample's; the step-clock values agree on the same traffic."""
    je, pe = engines(arch, n_slots=2, max_len=48, decode_chunk=2,
                     page_size=page_size)
    traffic = jobs(je.model.cfg.vocab, n=2, gen=4)
    serve(je, traffic)
    serve(pe, traffic)
    mine, theirs = pe.metrics.report(), je.metrics.report()
    assert mine.keys() == theirs.keys()
    for k in ("gather_bytes_avoided", "failovers", "trace_dropped"):
        assert k in mine
    for k in ("tokens_generated", "decode_steps", "requests_completed",
              "ttft_steps_p50", "latency_steps_p99", "gather_bytes_avoided",
              "pages_in_use", "host_syncs_decode"):
        assert mine[k] == theirs[k], k
    assert P.engine_sample(pe).keys() == J.engine_sample(je).keys()


@needs_jax
def test_router_sample_keys_equal_jax():
    out = []
    for pkg, m, kw in zip((J, P), models(DANUBE), ({}, dict(device="cpu"))):
        router = pkg.ReplicaRouter.build(
            m, pkg.EngineConfig(n_slots=2, max_len=48, **kw), 2)
        router.submit([1, 2, 3], 3)
        router.run()
        out.append(pkg.router_sample(router))
    theirs, mine = out
    assert mine.keys() == theirs.keys()
    assert mine["n_replicas"] == 2.0 and mine["overflow_depth"] == 0.0
    assert "replica0_n_waiting" in mine and "replica1_alive" in mine


@needs_jax
def test_engine_sample_and_jsonl(tmp_path):
    _, eng = engines(DANUBE, n_slots=2, max_len=48)
    serve(eng, [(0, [1, 2, 3], 4)])
    path = str(tmp_path / "tele.jsonl")
    exp = P.TelemetryExporter(lambda: P.engine_sample(eng),
                              P.TelemetryConfig(jsonl=path, process_index=1))
    s = exp.sample()
    assert s["tokens_generated"] == 4.0
    assert s["n_slots"] == 2.0 and s["n_active"] == 0.0
    line = json.loads(open(path).readline())
    assert line["sample"] == 1 and line["tokens_generated"] == 4.0
    assert line["process"] == 1
    # counter keys land as counters, point-in-time keys as gauges
    assert exp.registry.counter("tokens_generated").value == 4.0
    assert exp.registry.gauge("mean_occupancy").value > 0.0


@needs_jax
def test_prometheus_http_endpoint_and_cadence(tmp_path):
    """start() serves GET /metrics on 127.0.0.1 at an ephemeral port and
    samples on its cadence; a scrape mid-run sees the live counters; stop()
    takes a final sample, so the JSONL holds at least two lines, and tears
    the server down."""
    _, eng = engines(DANUBE, n_slots=2, max_len=48)
    path = str(tmp_path / "tele.jsonl")
    exp = P.TelemetryExporter(lambda: P.engine_sample(eng),
                              P.TelemetryConfig(interval=30.0, port=0,
                                                jsonl=path))
    exp.start()
    try:
        assert exp.port and exp.port > 0
        url = f"http://127.0.0.1:{exp.port}/metrics"
        serve(eng, [(0, [1, 2, 3], 3)])
        exp.sample()
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "serve_tokens_generated 3" in body
        assert "# TYPE serve_tokens_generated counter" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/nope",
                                   timeout=10)
    finally:
        exp.stop()
    assert len(open(path).readlines()) >= 2
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=2)
