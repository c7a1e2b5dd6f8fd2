"""Port parity, `examples_torch/serve_prefix.py` and
`serve_speculative.py` against `examples/`'s on the CPU: the JAX side runs
the JAX example's own `build_trace` / `run` on the JAX registry's model,
the port's `main` runs on the same weights (carried through
`checkpoint/convert.py`) with its own assertions. Greedy tokens per
request, the step-clock counters (prefix reuse, acceptance, per-slot
acceptance), the page pool's bytes, the draft's cost fraction within 1e-6
relative and the printed lines but their wall-clock rates."""

import re

import numpy as np

from torch_examples import (assert_fields_equal, carried, load,
                            one_torch_thread, tokens)  # noqa: F401

from repro import serve as J

STEP_FIELDS = ("tokens_generated", "decode_steps", "tokens_per_step",
               "host_syncs_per_token", "mean_occupancy",
               "requests_completed")
PREFIX_FIELDS = STEP_FIELDS + ("prefix_hit_rate", "prefill_tokens_skipped",
                               "prefill_skip_fraction", "pages_in_use",
                               "page_occupancy")
SPEC_FIELDS = STEP_FIELDS + ("tokens_per_dispatch", "acceptance_rate",
                             "draft_rolled_back")


def _scrub(text):
    """Printed lines without the wall-clock rates."""
    text = re.sub(r" +[\d.]+ admitted tok/s", " _ admitted tok/s", text)
    return re.sub(r"[\d.]+x admitted throughput", "_x admitted throughput",
                  text).splitlines()


def _scrub_count(text):
    """Printed lines without the draft's projection count (see below)."""
    return re.sub(r"draft packs \d+ projections", "draft packs _ projections",
                  text)


def test_serve_prefix_matches_jax(capsys):
    jex, ex = load("serve_prefix", port=False), load("serve_prefix")
    assert (ex.ARCH, ex.N_SLOTS, ex.PAGE, ex.SYS_LEN, ex.N_TURNS,
            ex.MAX_LEN) == (jex.ARCH, jex.N_SLOTS, jex.PAGE, jex.SYS_LEN,
                            jex.N_TURNS, jex.MAX_LEN)
    jex.main()
    want_lines = capsys.readouterr().out
    model = J.ModelRegistry().load(jex.ARCH)
    trace = jex.build_trace(model.cfg.vocab)
    for (p, g, a), (q, h, b) in zip(trace, ex.build_trace(model.cfg.vocab)):
        assert (list(p), g, a) == (list(q), h, b)
    slab, _, _, _ = jex.run(model, trace)
    paged, eng, _, reqs = jex.run(model, trace, page_size=jex.PAGE)
    out = ex.main(["--device", "cpu"], params=carried(ex.ARCH))
    assert _scrub(capsys.readouterr().out) == _scrub(want_lines)
    assert out["slab_tokens"] == [[int(t) for t in s] for s in slab]
    assert out["paged_tokens"] == tokens(reqs)
    assert_fields_equal(out["report"], eng.metrics.report(), PREFIX_FIELDS)
    assert out["matched"] == [(r.id, r.prefix_matched, len(r.prompt))
                              for r in reqs]
    assert out["pool_bytes"] == eng.pool.bytes()
    np.testing.assert_allclose(out["flops_per_token"],
                               2.0 * model.cfg.active_param_count(),
                               rtol=1e-6)


def test_serve_speculative_matches_jax(capsys):
    jex, ex = load("serve_speculative", port=False), \
        load("serve_speculative")
    assert (ex.ARCH, ex.K, ex.N_SLOTS, ex.MAX_LEN, ex.TRACE) \
        == (jex.ARCH, jex.K, jex.N_SLOTS, jex.MAX_LEN, jex.TRACE)
    assert ex.DRAFT.tag == jex.DRAFT.tag
    jex.main()
    want_lines = capsys.readouterr().out
    model = J.ModelRegistry().load(jex.ARCH, draft_spec=jex.DRAFT)
    plain, plain_eng = jex.run(model, 0)
    spec, spec_eng = jex.run(model, jex.K)
    out = ex.main(["--device", "cpu"], params=carried(ex.ARCH))
    assert _scrub_count(capsys.readouterr().out) == _scrub_count(want_lines)
    assert out["plain_tokens"] == [[int(t) for t in s] for s in plain]
    assert out["spec_tokens"] == [[int(t) for t in s] for s in spec]
    assert_fields_equal(out["plain_report"], plain_eng.metrics.report(),
                        STEP_FIELDS)
    assert_fields_equal(out["spec_report"], spec_eng.metrics.report(),
                        SPEC_FIELDS)
    assert out["slot_acceptance"] == {
        s: list(a) for s, a in spec_eng.metrics.slot_acceptance.items()}
    # both count a projection once for all the layers a scan stacks (smoke
    # nemotron: one scan over every layer)
    assert out["draft_packed"] == model.draft_packed
    np.testing.assert_allclose(out["draft_cost_fraction"],
                               model.draft_cost_fraction(), rtol=1e-6)
