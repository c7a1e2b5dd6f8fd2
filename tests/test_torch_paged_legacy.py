"""Port parity, the legacy gather/scatter paged decode
(`EngineConfig(paged_native=False)`; `serve/paging.py::PageLayout.gather`
/ `scatter`, `steps.make_paged_decode_step(native=False)`): greedy tokens
of the port's legacy and native forms against JAX's legacy engine on the
cases of `tests/test_paged_native.py` (plain and speculative), the
`GATHER_EVENTS` stream and the `gather_bytes_avoided` accounting,
`PageLayout.gather` / `scatter` bit for bit against JAX's on the same
store and table (duplicate sink and shared page ids included), the
gather-then-scatter round trip, and `PagedCachePool.describe()` against
JAX's. The `cuda` tests hold the card's gather / scatter to the CPU form
bit for bit and the graph-captured legacy dispatch to the eager one."""

import numpy as np
import pytest

from torch_serve_parity import (NEMOTRON, J, P, jax, models, needs_jax,
                                torch)
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch import configs as C
from repro_torch.instrument import REGISTRY
from repro_torch.serve.paging import GATHER_EVENTS, PageLayout

if jax is not None:
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.serve.paging import PageLayout as JPageLayout

ARCHS = [NEMOTRON, "jamba-v0.1-52b", "minicpm3_4b"]
PAGED = dict(n_slots=3, max_len=32, decode_chunk=2, page_size=8,
             prefix_cache=False)


def _jobs(vocab, seed=11, lens=((5, 6), (9, 4), (7, 5))):
    """The traffic of `tests/test_serve_paged.py::_jobs`."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0), gen) for s0, gen in lens]


def _run(pkg, model, jobs, **kw):
    eng = pkg.InferenceEngine(model, pkg.EngineConfig(**kw))
    reqs = [eng.submit(p, g, arrival_step=i) for i, (p, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs], eng


def _streams(arch, draft=False, **kw):
    """(JAX legacy, port legacy, port native) tokens and engines, with the
    port's gather events of each form."""
    jm, pm = models(arch, draft)
    jobs = _jobs(pm.cfg.vocab, **({"seed": 3} if draft else {}))
    want, jeng = _run(J, jm, jobs, paged_native=False, **kw)
    out = {}
    for native in (False, True):
        with REGISTRY.scoped("gather") as ev:
            toks, eng = _run(P, pm, jobs, paged_native=native, device="cpu",
                             **kw)
            out[native] = (toks, eng, list(ev["gather"]))
    return want, jeng, out


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_tokens_events_and_accounting(arch):
    """Port legacy == port native == JAX legacy greedy tokens; the native
    form appends no gather event, the legacy form both kinds (with JAX's
    leaf count and view bytes); gather_bytes_avoided is 2 x the view bytes
    a native dispatch, and 0 on the legacy form."""
    want, jeng, out = _streams(arch, **PAGED)
    (leg, eng_l, ev_l), (nat, eng_n, ev_n) = out[False], out[True]
    assert leg == want and nat == want
    assert ev_n == []
    view = eng_n.pool.layout.slab_view_bytes()
    assert view == jeng.pool.layout.slab_view_bytes()
    n_paged = sum(s.paged for s in jeng.pool.layout.specs)
    assert set(ev_l) == {("gather", n_paged, view), ("scatter", n_paged, view)}
    rep_l, rep_n = eng_l.metrics.report(), eng_n.metrics.report()
    assert [e[0] for e in ev_l] == ["gather", "scatter"] * int(
        rep_l["decode_steps"])
    assert eng_n.backend.gather_bytes_per_dispatch() == 2 * view \
        == jeng.pool.gather_bytes_per_dispatch()
    assert rep_n["gather_bytes_avoided"] == 2 * view * rep_n["decode_steps"] > 0
    assert rep_l["gather_bytes_avoided"] == 0.0
    assert eng_l.backend.gather_bytes_per_dispatch() == 0


@needs_jax
def test_legacy_speculative_matches_jax():
    """speculate=2 through the legacy paged wrap (draft w8): the port's
    legacy and native tokens equal JAX's legacy engine's."""
    want, _, out = _streams(NEMOTRON, draft=True, n_slots=3, max_len=32,
                            speculate=2, page_size=8)
    (leg, eng_l, ev_l), (nat, eng_n, ev_n) = out[False], out[True]
    assert leg == want and nat == want
    assert ev_n == [] and {e[0] for e in ev_l} == {"gather", "scatter"}
    assert eng_l.metrics.report()["spec_dispatches"] > 0
    assert eng_n.metrics.report()["gather_bytes_avoided"] > 0


# ---------------------------------------------------------------------------
# gather / scatter against JAX's, bit for bit
# ---------------------------------------------------------------------------

# 3 slots of 4 pages: the sink page 0 repeats within and across rows (a
# parked slot, rows past a slot's pages) and page 1 is shared by two rows
TABLE = np.array([[1, 2, 3, 0], [1, 4, 0, 0], [0, 0, 0, 0]], np.int32)
N_PAGES = 6


def _rand_layers(shapes, seed):
    rng = np.random.default_rng(seed)
    return [{n: rng.standard_normal(s).astype(np.float32)
             for n, s in layer.items()} for layer in shapes]


def _jax_tree(layers, cfg):
    """The reference's cache tree of per-layer arrays: prelude layers
    alone, each scan slot's layers stacked (the port's cross_k / cross_v
    are JAX's cross k / v)."""
    def entry(layer):
        e = {}
        for name, a in layer.items():
            g, leaf = ("cross", name[len("cross_"):]) \
                if name.startswith("cross_") else ("mixer", name)
            e.setdefault(g, {})[leaf] = a
        return e
    n0, p = cfg.prelude_layers, cfg.scan_period
    blocks = [jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[entry(layers[i]) for i in range(n0 + s, cfg.n_layers, p)])
        for s in range(p)]
    return {"prelude": [entry(layers[i]) for i in range(n0)],
            "blocks": blocks}


def _layouts(arch, cache_len, page_size=8):
    pl = PageLayout(C.get_smoke(arch), 3, cache_len, page_size,
                    device="cpu")
    jl = JPageLayout(JC.get_smoke(arch), 3, cache_len, page_size)
    return pl, jl


def _as_jax(layers, cfg):
    return [jnp.asarray(x) for x in
            jax.tree_util.tree_leaves(_jax_tree(layers, cfg))]


def _as_torch(layers):
    return [{n: torch.from_numpy(a.copy()) for n, a in layer.items()}
            for layer in layers]


def _flat(tree_or_leaves, cfg=None):
    """Flat numpy leaves in the reference's tree order."""
    if cfg is not None:            # port per-layer list
        tree_or_leaves = _jax_tree(
            [{n: t.numpy() for n, t in layer.items()}
             for layer in tree_or_leaves], cfg)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree_or_leaves)]


@needs_jax
@pytest.mark.parametrize("arch,cache_len", [
    (NEMOTRON, 32), ("jamba-v0.1-52b", 30), ("minicpm3_4b", 30),
    ("whisper-large-v3", 32)])
def test_gather_scatter_match_jax(arch, cache_len):
    """`gather` equals JAX's gather on the same store and table, and
    `scatter` of the same slab caches leaves the same store, bit for bit:
    the sink page and page 1 written more than once take their last
    write in table order, as in the reference's scatter; at cache_len 30
    the final page's padding is zeroed."""
    pl, jl = _layouts(arch, cache_len)
    cfg = pl.cfg
    store = _rand_layers(pl.store_shapes(N_PAGES), seed=0)
    caches = _rand_layers(pl.slab_shapes, seed=1)
    table = torch.from_numpy(TABLE)
    with REGISTRY.scoped("gather"):
        got = pl.gather(_as_torch(store), table)
        want = jl.gather(_as_jax(store, cfg), jnp.asarray(TABLE))
        for a, b in zip(_flat(got, cfg), _flat(want)):
            assert np.array_equal(a, b)
        mine = _as_torch(store)
        pl.scatter(mine, table, _as_torch(caches))
        theirs = jl.scatter(_as_jax(store, cfg), jnp.asarray(TABLE),
                            _jax_tree(caches, cfg))
        for a, b in zip(_flat(mine, cfg), _flat(theirs)):
            assert np.array_equal(a, b)
        assert [e[0] for e in GATHER_EVENTS] == ["gather", "scatter"]


@pytest.mark.parametrize("arch", [NEMOTRON, "jamba-v0.1-52b"])
def test_gather_then_scatter_leaves_store_unchanged(arch):
    """A gather followed by a scatter of the unchanged view is the
    identity on the store, the sink page read by several rows and the
    shared page included; resident leaves are the store's own tensors."""
    pl = PageLayout(C.get_smoke(arch), 3, 32, 8, device="cpu")
    store = _as_torch(_rand_layers(pl.store_shapes(N_PAGES), seed=2))
    before = [{n: t.clone() for n, t in layer.items()} for layer in store]
    table = torch.from_numpy(TABLE)
    with REGISTRY.scoped("gather"):
        view = pl.gather(store, table)
        for layer, v, paged in zip(store, view, pl.paged):
            for n in layer:
                assert (v[n] is layer[n]) == (not paged[n])
        pl.scatter(store, table, view)
    for a, b in zip(store, before):
        for n in a:
            assert torch.equal(a[n], b[n]), n


@needs_jax
@pytest.mark.parametrize("arch", ARCHS + ["whisper-large-v3"])
def test_pool_describe_matches_jax(arch):
    """`PagedCachePool.describe()` equals the JAX pool's after the same
    admissions (two slots' pages, one prompt published where the arch
    reuses prefixes)."""
    pools = [J.PagedCachePool(JC.get_smoke(arch), 3, 32, page_size=8),
             P.PagedCachePool(C.get_smoke(arch), 3, 32, page_size=8,
                              device="cpu")]
    prompt = np.arange(20) % 7
    for pool in pools:
        for n in (20, 9):
            pool.alloc_pages(pool.alloc(), n)
        pool.prefix_insert(prompt, 0)
    jd, pd = (p.describe() for p in pools)
    assert pd == jd


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_cuda_gather_scatter_match_cpu(cuda_device):
    """The card's gather and scatter equal the CPU form bit for bit, the
    duplicate page ids of the sink and a shared page included (their
    values routed through `last_write`, so the card's arbitrary winner
    among duplicates carries the last write's value)."""
    pl = {d: PageLayout(C.get_smoke(NEMOTRON), 3, 30, 8, device=d)
          for d in ("cpu", "cuda")}
    store = _rand_layers(pl["cpu"].store_shapes(N_PAGES), seed=0)
    caches = _rand_layers(pl["cpu"].slab_shapes, seed=1)
    out = {}
    with REGISTRY.scoped("gather"):
        for d, layout in pl.items():
            s = [{n: t.to(d) for n, t in layer.items()}
                 for layer in _as_torch(store)]
            table = torch.from_numpy(TABLE).to(d)
            view = layout.gather(s, table)
            layout.scatter(s, table, [{n: t.to(d) for n, t in layer.items()}
                                      for layer in _as_torch(caches)])
            out[d] = (view, s)
    for got, want in zip(out["cuda"], out["cpu"]):
        for a, b in zip(got, want):
            for n in a:
                assert torch.equal(a[n].cpu(), b[n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(decode_chunk=2), dict(speculate=2)])
def test_cuda_legacy_graph_matches_eager(cuda_device, kw):
    """The legacy paged dispatch, captured into the backend's CUDA graph,
    gives the eager step's tokens (and native paged decode's); the
    captured gather and scatter append their events once per capture,
    never per replay."""
    draft = P.DraftSpec(bits=8) if "speculate" in kw else None
    m = P.ModelRegistry().load(NEMOTRON, device="cuda", draft_spec=draft)
    jobs = _jobs(m.cfg.vocab)
    out = {}
    for native, eager in ((False, False), (False, True), (True, False)):
        with REGISTRY.scoped("gather") as ev:
            eng = P.InferenceEngine(m, P.EngineConfig(
                n_slots=3, max_len=32, page_size=8, paged_native=native,
                **kw))
            n_capture = len(ev["gather"])
            if eager:
                eng.backend._graph = None
            reqs = [eng.submit(p, g, arrival_step=i)
                    for i, (p, g) in enumerate(jobs)]
            eng.run()
            out[native, eager] = [list(r.generated) for r in reqs]
            if not native and not eager:
                assert n_capture == 4          # warm-up + capture, x2 kinds
                assert len(ev["gather"]) == n_capture
            if native:
                assert not ev["gather"]
    assert out[False, False] == out[False, True] == out[True, False]
