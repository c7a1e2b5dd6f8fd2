"""Port parity, `examples_torch/serve_router.py` and `serve_traced.py`
against `examples/`'s on the CPU (the JAX examples run as shipped, their
router and engine recorded; the port's `main` on the same weights,
carried through `checkpoint/convert.py`, with its own assertions): greedy
tokens per request, the router's rejections, spills and tokens per
replica, the engine's step-clock counters, each request's span on the
step clock, the exported event count and the printed lines but their
wall-clock figures."""

import re

from torch_examples import (assert_fields_equal, carried, load,
                            one_torch_thread, record, tokens)  # noqa: F401

ROUTER_FIELDS = ("requests_completed", "tokens_generated", "router_steps",
                 "tokens_per_router_step", "mean_occupancy", "spills",
                 "overflowed", "rebalanced", "rejected", "rejected_fleet")
STEP_FIELDS = ("tokens_generated", "decode_steps", "tokens_per_step",
               "host_syncs_per_token", "mean_occupancy",
               "requests_completed")


def _scrub(text):
    """Printed lines without the wall-clock figures and export paths."""
    for pat, sub in ((r"[\d.]+ tok/s wall", "_ tok/s wall"),
                     (r"toks in [\d.]+s", "toks in _s"),
                     (r" +[\d.]+ ms", " _ ms"),
                     (r"wrote \S+", "wrote _")):
        text = re.sub(pat, sub, text)
    return text.splitlines()


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_serve_router_matches_jax(capsys):
    jex, ex = load("serve_router", port=False), load("serve_router")
    assert (ex.N_REPLICAS, ex.N_SLOTS, ex.MAX_WAITING, ex.TRACE) \
        == (jex.N_REPLICAS, jex.N_SLOTS, jex.MAX_WAITING, jex.TRACE)
    routers = record(jex, "ReplicaRouter")
    jex.main()
    want_lines = capsys.readouterr().out
    out = ex.main(["--device", "cpu"], params=carried(ex.ARCH, jex.SPEC))
    assert _scrub(capsys.readouterr().out) == _scrub(want_lines)
    (router,) = routers
    assert out["tokens"] == tokens(router.submitted)
    assert out["per_replica"] == [int(e.metrics.tokens_generated)
                                  for e in router.replicas]
    assert_fields_equal(out["report"], router.report(), ROUTER_FIELDS)
    assert out["report"]["rejected"] > 0 and out["report"]["spills"] > 0


def test_serve_traced_matches_jax(capsys, tmp_path, monkeypatch):
    jex, ex = load("serve_traced", port=False), load("serve_traced")
    assert ex.TRACE == jex.TRACE
    engines = record(jex, "InferenceEngine")
    monkeypatch.chdir(tmp_path)             # the JAX example's exports
    jex.main()
    want_lines = capsys.readouterr().out
    out = ex.main(["--device", "cpu", "--out-dir", str(tmp_path / "port")],
                  params=carried(ex.ARCH, jex.SPEC))
    assert _scrub(capsys.readouterr().out) == _scrub(want_lines)
    (eng,) = engines
    assert out["tokens"] == tokens(eng.submitted)
    assert_fields_equal(out["report"], eng.metrics.report(), STEP_FIELDS)
    spans = eng.trace.request_spans()
    for r, got in zip(eng.submitted, out["spans"]):
        want = spans[r.id]
        on_steps = [k for k in want
                    if not k.endswith(("_t", "_s", "_ms"))]
        assert {k: got[k] for k in on_steps} == {k: want[k]
                                                 for k in on_steps}
    assert (out["n_events"], out["dropped"]) == (len(eng.trace.events),
                                                 eng.trace.dropped)
    # the JSONL exports, line for line on the step clock
    assert len(_lines(out["jsonl"])) == len(_lines(jex.OUT_JSONL))
    assert (tmp_path / "port" / "serve.chrome.json").stat().st_size > 0
