"""Shared helpers of the port's serving-layer parity tests
(`test_torch_trace.py`, `test_torch_telemetry.py`, `test_torch_router.py`,
`test_torch_chaos.py`): the same seeded smoke weights carried into both
packages through `checkpoint/convert.py`, seeded traffic, trace-event
normalisation and the pool-pristine check. Not a test module itself."""

import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    from repro import configs as JC
    from repro import serve as J
    from repro.checkpoint.manager import save_pytree
    from repro.models import transformer as JT

from repro_torch import serve as P
from repro_torch.checkpoint.convert import convert

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
DANUBE, NEMOTRON = "h2o-danube-1.8b", "nemotron-4-340b"
# event fields on the wall clock, and the profiler's directory: left out of
# the stream comparison
WALL_FIELDS = ("t", "dur", "dir")
# the ledger event's float fields: activations differ by f32 rounding
LEDGER_FLOATS = ("zero_frac", "near_frac", "dead_frac", "eff_flop_frac",
                 "flops_eff")
LEDGER_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(JAX params, the port's dense params) on the same weights."""
    cfg = JC.get_smoke(arch)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return params, ported


@functools.lru_cache(maxsize=None)
def models(arch, draft=False):
    """(JAX model, port model) on the carried weights; `draft` loads both
    with a w8 self-draft."""
    params, ported = carried(arch)
    jkw = dict(draft_spec=J.DraftSpec(bits=8)) if draft else {}
    kw = dict(draft_spec=P.DraftSpec(bits=8)) if draft else {}
    return (J.ModelRegistry().load(arch, params=params, **jkw),
            P.ModelRegistry().load(arch, params=ported, device="cpu", **kw))


def engines(arch, draft=False, **cfg_kw):
    """(JAX engine, port engine) on the same model and config; TraceConfig
    and LedgerConfig values are given as dicts of their fields."""
    jm, pm = models(arch, draft)
    out = []
    for pkg, m, extra in ((J, jm, {}), (P, pm, dict(device="cpu"))):
        kw = dict(cfg_kw, **extra)
        for field, cls in (("trace", "TraceConfig"),
                           ("ledger", "LedgerConfig")):
            if isinstance(kw.get(field), dict):
                kw[field] = getattr(pkg, cls)(**kw[field])
        out.append(pkg.InferenceEngine(m, pkg.EngineConfig(**kw)))
    return out


def jobs(vocab, n=3, prompt=6, gen=5, seed=0, stagger=1):
    """n seeded (arrival_step, prompt, max_new_tokens) requests."""
    rng = np.random.default_rng(seed)
    return [(i * stagger, rng.integers(0, vocab, prompt + i), gen)
            for i in range(n)]


def serve(eng, traffic):
    reqs = [eng.submit(p, g, arrival_step=a) for a, p, g in traffic]
    eng.run()
    return reqs


def events(tracer):
    """The tracer's events without the wall-clock fields."""
    return [{k: v for k, v in ev.items() if k not in WALL_FIELDS}
            for ev in tracer.events]


def assert_events_equal(got, want):
    """Field by field; the ledger event's float fields within 1e-3."""
    assert [e["ev"] for e in got] == [e["ev"] for e in want]
    for g, w in zip(got, want):
        if g["ev"] == "ledger":
            assert g.keys() == w.keys()
            for k in g:
                if k in LEDGER_FLOATS:
                    # the effective FLOPs as a share of the dense ones
                    scale = max(1.0, w["flops_dense"]) \
                        if k == "flops_eff" else 1.0
                    assert abs(g[k] - w[k]) <= LEDGER_TOL * scale, (k, g, w)
                else:
                    assert g[k] == w[k], (k, g, w)
        else:
            assert g == w


def assert_pristine(eng):
    """Every slot free; on a paged pool every surviving page reference is
    the prefix tree's, and clearing the tree frees every page."""
    assert eng.pool.n_active == 0
    assert eng.pool.n_free == eng.cfg.n_slots
    if hasattr(eng.pool, "_free_pages"):
        if getattr(eng.pool, "index", None) is not None:
            assert eng.pool.pages_in_use == eng.pool.index.n_nodes
            eng.pool.index.clear(eng.pool._release)
        assert int(np.asarray(eng.pool.refs)[1:].sum()) == 0
        assert len(eng.pool._free_pages) == eng.pool.n_usable_pages
