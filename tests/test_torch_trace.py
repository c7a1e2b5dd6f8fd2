"""Port parity, serve tracing (`repro_torch.serve.trace`): the zero-cost
disabled path, the engine's event stream against the JAX engine's on the
same carried weights and traffic (slab at K 1 and 3, paged with prefix
reuse, speculative, the host loop, the ledger), span and metrics
reconciliation, the JSONL and Chrome exports against JAX's, the ring
buffer, the torch.profiler bracket, and the report-key repair
(`gather_bytes_avoided`). The `cuda` test holds the bracket on the card to
the port's kernels inside graph replays."""

import gc
import json
import os
import sys

import numpy as np
import pytest

from torch_serve_parity import (DANUBE, NEMOTRON, J, P, assert_events_equal,
                                engines, events, jobs, models, needs_jax,
                                serve, torch)
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.kernels import ops
from repro_torch.serve.trace import NullTracer


def _engine(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    return P.InferenceEngine(models(DANUBE)[1],
                             P.EngineConfig(device="cpu", **kw))


# ---------------------------------------------------------------------------
# the disabled path: zero cost
# ---------------------------------------------------------------------------

@needs_jax
def test_engine_defaults_to_null_tracer():
    eng = _engine()
    assert eng.trace is P.NULL_TRACER and not eng.trace.enabled
    assert eng.pool.tracer is P.NULL_TRACER


def test_null_tracer_zero_alloc():
    """The disabled hot path allocates nothing: fixed-arity no-op hooks
    (the JAX test's hot path, plus the ledger, quality-probe, gather and
    conversation hooks). The first passes may warm CPython's adaptive
    specialisation; the last measurement is the steady state."""
    t = P.NULL_TRACER

    def hot_path():
        t.step = 7
        t.dispatch_begin()
        t.decode_dispatch(4, 2, 2)
        t.host_sync("decode", 32)
        t.first_token(1, 0, 3)
        t.finish(1, 0, 9, 6)
        t.submit(1, 2, 3)
        t.admit(1, 0, 0, 4)
        t.prefill(1, 0, 4, 8, False)
        t.pool_wait()
        t.page_alloc(0, 1, 2)
        t.page_free(0, 3)
        t.page_evict(1)
        t.spec_dispatch(4, 2, 2)
        t.spec_slot(0, 3, 4, 4)
        t.reject(5)
        t.tier_change(0, 1, 9)
        t.req_tier(1, 1)
        t.shed(1, 0, "deadline", 3)
        t.failover(1, 0)
        t.fault("crash", "injected")
        t.ledger_dispatch(7, 0.5, 0.25, 0.125, 0.75, 64.0, 48.0)
        t.quality_probe(1, 1, True, 0.5)
        t.gather_avoided(4096)
        t.conversation_hit(1, 16)

    deltas = []
    for _ in range(3):
        hot_path()
        gc.collect()
        before = sys.getallocatedblocks()
        hot_path()
        deltas.append(sys.getallocatedblocks() - before)
    assert deltas[-1] == 0, f"disabled tracer allocated: deltas={deltas}"


def test_null_tracer_returns_empty_views():
    assert P.NULL_TRACER.request_spans() == {}
    assert P.NULL_TRACER.export() is None
    assert isinstance(P.NULL_TRACER, NullTracer)
    assert P.Tracer(P.TraceConfig()).enabled


# ---------------------------------------------------------------------------
# the event stream against the JAX engine's
# ---------------------------------------------------------------------------

# (arch, draft, engine config, traffic kwargs)
STREAMS = {
    "slab-k1": (DANUBE, False, dict(decode_chunk=1), {}),
    "slab-k3": (DANUBE, False, dict(decode_chunk=3), {}),
    # a shared 16-token system prompt: the later admissions match its pages
    "paged-prefix": (NEMOTRON, False, dict(page_size=8, decode_chunk=2),
                     dict(shared=16)),
    "spec-k2": (NEMOTRON, True, dict(speculate=2), {}),
    "host-loop": (DANUBE, False, dict(device_loop=False), {}),
}


def _stream_traffic(vocab, shared=0):
    traffic = jobs(vocab, n=3, gen=5)
    if shared:
        head = np.random.default_rng(9).integers(0, vocab, shared)
        traffic = [(a, np.concatenate([head, p]), g) for a, p, g in traffic]
    return traffic


@needs_jax
@pytest.mark.parametrize("case", list(STREAMS))
def test_event_stream_matches_jax(case, tmp_path):
    """Every event the port's engine records equals the JAX engine's, field
    by field, on the same traffic (t, dur and the profiler's dir left
    out); host_sync bytes are exact. The slab K 1 case also runs the
    profiler bracket on both (JAX's jax.profiler, the port's
    torch.profiler), whose start and stop events stand in the stream."""
    arch, draft, cfg, traffic_kw = STREAMS[case]
    trace = dict(profile_dir=str(tmp_path)) if case == "slab-k1" else {}
    je, pe = engines(arch, draft, n_slots=2, max_len=64, trace=trace, **cfg)
    traffic = _stream_traffic(je.model.cfg.vocab, **traffic_kw)
    jr, pr = serve(je, traffic), serve(pe, traffic)
    assert [r.generated for r in pr] == [r.generated for r in jr]
    got, want = events(pe.trace), events(je.trace)
    assert_events_equal(got, want)
    kinds = {e["ev"] for e in got}
    if case == "slab-k1":
        assert {"profile_start", "profile_stop"} <= kinds
        assert os.path.isfile(pe.trace.profile_path)
    if case == "paged-prefix":
        assert {"page_alloc", "page_free"} <= kinds
        assert pe.metrics.prefix_hits > 0
        assert any(e["prefix_matched"] > 0 for e in got if e["ev"] == "admit")
        assert "gather_avoided" in kinds
    if case == "spec-k2":
        assert {"spec", "spec_slot"} <= kinds
    assert pe.metrics.trace_dropped == je.metrics.trace_dropped == 0


@needs_jax
def test_ledger_event_stream_matches_jax():
    """With the ledger on, the ledger events' fractions equal JAX's within
    1e-3 and every other field exactly; a decode host_sync's bytes are the
    JAX engine's plus the (n_layers, width) f32 matrix that rides the
    port's one dispatch copy."""
    je, pe = engines(NEMOTRON, n_slots=2, max_len=48, decode_chunk=2,
                     trace={}, ledger=dict(k_block=8))
    traffic = jobs(je.model.cfg.vocab, n=3, gen=5)
    serve(je, traffic)
    serve(pe, traffic)
    got, want = events(pe.trace), events(je.trace)
    extra = 4 * pe.model.cfg.n_layers * pe.cfg.ledger.width
    for e in want:
        if e["ev"] == "host_sync" and e["kind"] == "decode":
            e["bytes"] += extra
    assert_events_equal(got, want)
    assert sum(e["ev"] == "ledger" for e in got) == pe.metrics.decode_steps


@needs_jax
def test_quality_probe_and_tier_events_match_jax():
    """The quality probe's events (its host_sync bytes, top-1 and mean
    |logit difference| within 1e-4) and a tier change's, against JAX's."""
    from torch_serve_parity import carried
    params, ported = carried(DANUBE)
    jm = J.ModelRegistry().load(DANUBE, params=params, tier_specs=(
        J.DraftSpec.from_args(8, 0.5, 0),))
    pm = P.ModelRegistry().load(DANUBE, params=ported, device="cpu",
                                tier_specs=(P.DraftSpec.from_args(8, 0.5, 0),))
    out = []
    for pkg, m, kw in ((J, jm, {}), (P, pm, dict(device="cpu"))):
        eng = pkg.InferenceEngine(m, pkg.EngineConfig(
            n_slots=2, max_len=48, trace=pkg.TraceConfig(),
            ledger=pkg.LedgerConfig(quality_every=1), **kw))
        eng.set_tier(1)
        serve(eng, jobs(m.cfg.vocab, n=2, gen=3))
        out.append([e for e in events(eng.trace)
                    if e["ev"] in ("quality_probe", "tier_change", "req_tier")
                    or e.get("kind") == "quality"])
    got, want = out[1], out[0]
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "mad":
                assert abs(g[k] - w[k]) <= 1e-4
            else:
                assert g[k] == w[k], (k, g, w)
    assert any(e["ev"] == "quality_probe" for e in got)


@needs_jax
def test_gather_bytes_avoided_matches_jax():
    """The report-key repair: a paged port engine's pool reports JAX's
    gather bytes per dispatch, and `gather_bytes_avoided` after the same
    traffic equals JAX's (0 on the slab)."""
    for page_size in (8, None):
        je, pe = engines(NEMOTRON, n_slots=2, max_len=48, decode_chunk=2,
                         page_size=page_size)
        assert pe.backend.gather_bytes_per_dispatch() \
            == je.backend.gather_bytes_per_dispatch()
        traffic = jobs(je.model.cfg.vocab, n=3, gen=5)
        serve(je, traffic)
        serve(pe, traffic)
        got = pe.metrics.report()["gather_bytes_avoided"]
        assert got == je.metrics.report()["gather_bytes_avoided"]
        assert (got > 0) == (page_size is not None)


# ---------------------------------------------------------------------------
# spans reconcile with ServeMetrics
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("decode_chunk", [1, 3])
def test_spans_reconcile_with_metrics(decode_chunk):
    """Step-clock span fields equal the metrics records, and the report's
    percentiles, also at K > 1 where micro-steps run ahead of the dispatch
    clock."""
    eng = _engine(decode_chunk=decode_chunk, trace=P.TraceConfig())
    reqs = [eng.submit([1, 2, 3, 4, 5], 6),
            eng.submit([7, 8, 9], 4, arrival_step=1),
            eng.submit([5, 4, 3, 2], 5, arrival_step=2)]
    eng.run()
    spans = eng.trace.request_spans()
    assert len(spans) == len(reqs)
    for r in reqs:
        s, rec = spans[r.id], eng.metrics.records[r.id]
        assert s["ttft_steps"] == rec.first_token_step - rec.arrival_step
        assert s["latency_steps"] == rec.finish_step - rec.arrival_step
        assert s["queue_steps"] == rec.start_step - rec.arrival_step
        assert s["tokens"] == rec.n_generated == len(r.generated)
        assert s["n_prompt"] == rec.n_prompt
        assert s["ttft_s"] >= 0.0 and s["latency_s"] >= s["ttft_s"]
    rep = eng.metrics.report()
    ttft = sorted(s["ttft_steps"] for s in spans.values())
    lat = sorted(s["latency_steps"] for s in spans.values())
    assert rep["ttft_steps_p50"] == ttft[1]
    assert rep["latency_steps_p50"] == lat[1]
    assert rep["latency_steps_p99"] == lat[-1]


@needs_jax
def test_trace_counts_match_metrics_counters():
    eng = _engine(decode_chunk=2, trace=P.TraceConfig())
    eng.submit([1, 2, 3], 4)
    eng.submit([4, 5], 3, arrival_step=1)
    eng.run()
    by_kind = {}
    for ev in eng.trace.events:
        by_kind.setdefault(ev["ev"], []).append(ev)
    assert len(by_kind["decode"]) == eng.metrics.decode_steps
    assert len(by_kind["submit"]) == 2
    assert len(by_kind["admit"]) == eng.metrics.prefills
    assert len(by_kind["finish"]) == 2
    syncs = [e for e in by_kind["host_sync"] if e["kind"] == "decode"]
    assert len(syncs) == eng.metrics.host_syncs["decode"]
    assert all(e["bytes"] == 4 * 2 * 2 for e in syncs)      # (K, B) int32
    for e in by_kind["decode"]:
        assert e["dur"] >= 0.0 and 0.0 < e["occupancy"] <= 1.0
        assert e["k"] == 2


@needs_jax
def test_format_timeline_mentions_the_numbers():
    eng = _engine(trace=P.TraceConfig())
    r = eng.submit([1, 2, 3], 4)
    eng.run()
    text = eng.trace.format_timeline(r.id)
    assert f"req{r.id}" in text
    assert "ttft" in text and "generated 4 tokens" in text
    assert "no events retained" in eng.trace.format_timeline(999)


# ---------------------------------------------------------------------------
# exports against JAX's
# ---------------------------------------------------------------------------

def _without(evs, keys):
    return [{k: v for k, v in e.items() if k not in keys} for e in evs]


@needs_jax
def test_exports_match_jax(tmp_path):
    """The JSONL meta line's and every event line's keys equal JAX's, the
    event lines equal JAX's minus the wall clock, and the Chrome events
    equal JAX's minus ts / dur."""
    je, pe = engines(DANUBE, n_slots=2, max_len=48, decode_chunk=2,
                     trace={})
    traffic = jobs(je.model.cfg.vocab, n=3, gen=4)
    serve(je, traffic)
    serve(pe, traffic)
    lines = []
    for pkg, eng in ((J, je), (P, pe)):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        n = pkg.export_jsonl([eng.trace], path)
        doc = [json.loads(line) for line in open(path)]
        assert len(doc) == n + 1
        lines.append(doc)
    want, got = lines
    assert [sorted(d) for d in got] == [sorted(d) for d in want]
    assert got[0]["ev"] == "meta" and got[0]["dropped"] == 0
    assert _without(got[1:], ("t", "dur")) == _without(want[1:], ("t", "dur"))
    path = str(tmp_path / "port.json")
    n = P.export_chrome([pe.trace], path)
    doc = json.load(open(path))
    assert n == len(doc["traceEvents"]) > 0
    from repro.serve.trace import chrome_events as j_chrome_events
    assert _without(doc["traceEvents"], ("ts", "dur")) == \
        _without(j_chrome_events(je.trace), ("ts", "dur"))
    assert {"M", "X", "C", "i"} <= {e["ph"] for e in doc["traceEvents"]}


@needs_jax
def test_export_chrome_reconciles_with_metrics(tmp_path):
    eng = _engine(decode_chunk=2, trace=P.TraceConfig())
    reqs = [eng.submit([1, 2, 3, 4], 5), eng.submit([9, 8], 4,
                                                    arrival_step=1)]
    eng.run()
    path = str(tmp_path / "trace.json")
    P.export_chrome([eng.trace], path)
    req_spans = {e["name"]: e for e in json.load(open(path))["traceEvents"]
                 if e.get("cat") == "request"}
    assert len(req_spans) == len(reqs)
    for r in reqs:
        rec = eng.metrics.records[r.id]
        args = req_spans[f"req{r.id}"]["args"]
        assert args["ttft_steps"] == rec.first_token_step - rec.arrival_step
        assert args["latency_steps"] == rec.finish_step - rec.arrival_step
        assert args["tokens"] == len(r.generated)


@needs_jax
def test_tracer_export_uses_config_paths(tmp_path):
    out, chrome = str(tmp_path / "a.jsonl"), str(tmp_path / "b.json")
    eng = _engine(trace=P.TraceConfig(out=out, chrome=chrome))
    eng.submit([1, 2], 3)
    eng.run()
    eng.trace.export()
    assert json.loads(open(out).readline())["ev"] == "meta"
    assert "traceEvents" in json.load(open(chrome))


# ---------------------------------------------------------------------------
# the ring buffer
# ---------------------------------------------------------------------------

def test_ring_buffer_caps_and_counts_drops():
    tr = P.Tracer(P.TraceConfig(capacity=4))
    for _ in range(10):
        tr.host_sync("decode", 4)
    assert len(tr.events) == 4 and tr.dropped == 6
    # a request whose submit edge fell off the ring is omitted from spans
    tr2 = P.Tracer(P.TraceConfig(capacity=2))
    tr2.submit(1, 3, 0)
    for _ in range(3):
        tr2.host_sync("decode", 4)
    assert tr2.request_spans() == {}


@needs_jax
def test_engine_mirrors_drops_into_the_report_like_jax():
    """A small ring drops the same events as JAX's on the same traffic,
    and `trace_dropped` in both reports counts them as of the last
    dispatch (the finish edges after it drop more)."""
    je, pe = engines(DANUBE, n_slots=2, max_len=48, trace=dict(capacity=8))
    traffic = jobs(je.model.cfg.vocab, n=2, gen=4)
    serve(je, traffic)
    serve(pe, traffic)
    assert pe.trace.dropped == je.trace.dropped > 0
    assert 0 < pe.metrics.report()["trace_dropped"] \
        == je.metrics.report()["trace_dropped"] <= pe.trace.dropped
    assert_events_equal(events(pe.trace), events(je.trace))


# ---------------------------------------------------------------------------
# the profiler bracket on the CPU
# ---------------------------------------------------------------------------

@needs_jax
def test_profiler_bracket_writes_its_trace(tmp_path):
    """The bracket opens at the first traced dispatch, closes after
    `profile_dispatches`, pushes profile_start (with dir and dispatches)
    and profile_stop, and writes a Chrome trace holding CPU ops."""
    eng = _engine(trace=P.TraceConfig(profile_dir=str(tmp_path),
                                      profile_dispatches=2))
    eng.submit([1, 2, 3], 6)
    eng.run()
    evs = list(eng.trace.events)
    start = next(e for e in evs if e["ev"] == "profile_start")
    assert start["dir"] == str(tmp_path) and start["dispatches"] == 2
    i0 = evs.index(start)
    i1 = next(i for i, e in enumerate(evs) if e["ev"] == "profile_stop")
    assert sum(e["ev"] == "decode" for e in evs[i0:i1]) == 2
    doc = json.load(open(eng.trace.profile_path))
    assert os.path.dirname(eng.trace.profile_path) == str(tmp_path)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_second_bracket_is_skipped_while_one_is_open(tmp_path):
    """kineto admits one session a process: a second tracer's bracket that
    would open while the first is open is skipped (no events, nothing
    left to profile), and the first one closes normally."""
    cfg = P.TraceConfig(profile_dir=str(tmp_path), profile_dispatches=1)
    a, b = P.Tracer(cfg, replica=0), P.Tracer(cfg, replica=1)
    a.dispatch_begin()
    b.dispatch_begin()
    assert a._profiling and not b._profiling and b._profile_left == 0
    b.decode_dispatch(1, 1, 1)
    a.decode_dispatch(1, 1, 1)
    assert [e["ev"] for e in a.events] == ["profile_start", "decode",
                                           "profile_stop"]
    assert [e["ev"] for e in b.events] == ["decode"]
    assert os.path.isfile(a.profile_path) and b.profile_path is None


# ---------------------------------------------------------------------------
# a traced run is token-identical
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("cfg", [dict(decode_chunk=2),
                                 dict(decode_chunk=2, page_size=8)])
def test_tracing_does_not_change_tokens(cfg):
    prompts = [([1, 2, 3, 4], 5), ([9, 8, 7], 4)]
    outs = []
    for trace in (None, P.TraceConfig()):
        eng = _engine(trace=trace, **cfg)
        reqs = [eng.submit(p, g, arrival_step=i)
                for i, (p, g) in enumerate(prompts)]
        eng.run()
        outs.append([list(r.generated) for r in reqs])
        assert eng.pool.tracer is eng.trace
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_cuda_profiler_bracket_captures_graph_replays(cuda_device, tmp_path):
    """On the card the bracket records CUDA activity: its Chrome trace
    holds the port's kernels launched by the decode graph's replays, and a
    traced engine launches exactly what an untraced one does, with the
    same tokens."""
    m = P.ModelRegistry().load(NEMOTRON)
    out = []
    for trace in (None, P.TraceConfig(profile_dir=str(tmp_path),
                                      profile_dispatches=2)):
        eng = P.InferenceEngine(m, P.EngineConfig(n_slots=2, max_len=48,
                                                  decode_chunk=2,
                                                  trace=trace))
        reqs = [eng.submit(np.arange(3 + i) + 1, 6) for i in range(2)]
        ops.reset_launch_counts()
        eng.run()
        out.append(([list(r.generated) for r in reqs], ops.launch_counts()))
    assert out[0] == out[1]
    doc = json.load(open(eng.trace.profile_path))
    kernels = [e["name"] for e in doc["traceEvents"]
               if e.get("cat") == "kernel"]
    assert any("gemv_cluster_kernel" in k or "gemm" in k for k in kernels)
    assert any("cudaGraphLaunch" in e.get("name", "")
               for e in doc["traceEvents"])
