"""Port parity, paged KV with prefix reuse: the plain version of
`paged_flash_attention` against the JAX Pallas kernel in interpret mode;
the port's `PagedCachePool` against `repro.serve.paging`'s on one random
alloc / match / insert / free / evict sequence; and the port's paged
engine against JAX's on a shared-system-prompt trace followed by a
conversation's second turn, for the dense, w4 and w8a8 specs at K in
{1, 2}: greedy tokens, `prefix_matched` lists and reuse counters equal,
and the drain returns the pool to pristine."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.core import kratos as jkr
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry
    from repro.serve import PagedCachePool as JPool
    from repro.serve import PoolExhausted as JPoolExhausted

    from test_torch_serve import _record_decode_host_reads

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.serve import (EngineConfig, InferenceEngine, ModelRegistry,
                               PagedCachePool, PoolExhausted,
                               prefix_supported)

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
NEMOTRON, DANUBE = "nemotron-4-340b", "h2o-danube-1.8b"
SPECS = {"dense": {}, "w4": dict(bits=4), "w8a8": dict(bits=8, act_bits=8)}
# reuse counters that do not depend on the dispatch grouping K, and the two
# per-dispatch page gauges that do
REUSE_KEYS = ("prefix_hit_rate", "prefill_skip_fraction",
              "prefill_tokens_skipped", "conversation_prefix_hits",
              "conversation_tokens_reused", "pool_waits",
              "requests_completed", "tokens_generated")
GAUGE_KEYS = ("pages_in_use", "page_occupancy")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread than
    spread over many (and the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# kernel: plain version vs Pallas interpret
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("h,h_kv,sq,window,softcap", [
    (4, 4, 1, None, None),
    (8, 2, 1, None, None),                 # GQA
    (8, 2, 3, None, 30.0),                 # verify-sized block + softcap
    (8, 2, 1, 6, None),                    # sliding window
    (8, 2, 3, 6, 50.0),
])
def test_paged_attention_plain_vs_pallas(h, h_kv, sq, window, softcap):
    b, pp, page, d = 4, 5, 4, 16
    rng = np.random.default_rng(h * 10 + sq)
    n_pages = b * pp + 1
    kp, vp = rnd(1, (n_pages, h_kv, page, d)), rnd(2, (n_pages, h_kv, page, d))
    table = (rng.permutation(n_pages - 1)[:b * pp] + 1).reshape(b, pp)
    table = table.astype(np.int32)
    last = np.array([pp * page - 1, 6, 9, 13], np.int32)
    table[1, 2:] = 0          # pages past the slot's footprint: the sink
    table[2] = 0              # an idle slot parked on the sink page
    q = rnd(3, (b, h, sq, d))
    want = jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(last), window=window, softcap=softcap,
        backend="interpret")
    got = pops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(last), window=window,
        softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_paged_attention_matches_plain_version(cuda_device):
    """The page-table kernel against its plain version on the card, at
    FA_TOL: f32, bf16 and both mixed pairs; head dims 80 and 192 (h2o-danube
    and nemotron widths) and 16; sq 1 and 3; window and softcap. Over 8
    slots the plan splits a slot's pages 4 ways (d 80), 1-4 ways (d 192)
    and not at all (d 16): slot 3 is idle on the sink page, slot 5 holds 2
    live pages, fewer than 4 splits, slot 6's first query row sits at
    position 0. Over 2 slots of a 128-page table the plan splits 8 ways:
    slot 0 is long, slot 1 holds 2 live pages, so 6 of its 8 ranks get an
    empty share (window 64 leaves empty ranks in slot 0 too). A second call
    is bitwise equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    page = 16
    for b, heads, h_kv, d, pp in ((8, 32, 8, 80, 34), (8, 96, 8, 192, 48),
                                  (8, 8, 2, 16, 12), (2, 32, 8, 80, 128)):
        n_pages = b * pp + 1
        perm = torch.randperm(n_pages - 1, generator=gen,
                              device=cuda_device) + 1
        table = perm.reshape(b, pp).to(torch.int32)
        last = torch.randint(pp * page // 4, pp * page, (b,), generator=gen,
                             device=cuda_device).to(torch.int32)
        if b == 8:
            table[3] = 0
            last[5], last[6] = 20, 2
        else:
            last[0], last[1] = pp * page - 5, 20
            assert all(fa.paged_plan(b, heads, h_kv, sq, d, page, pp,
                                     elem).split == 8
                       for sq in (1, 3) for elem in (4, 2))
        kp32 = torch.randn((n_pages, h_kv, page, d), generator=gen,
                           device=cuda_device)
        vp32 = torch.randn((n_pages, h_kv, page, d), generator=gen,
                           device=cuda_device)
        for q_dt, kv_dt in ((torch.float32, torch.float32),
                            (torch.bfloat16, torch.bfloat16),
                            (torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.float32)):
            atol, rtol = (2e-3, 2e-3) if torch.bfloat16 not in (q_dt, kv_dt) \
                else (8e-3, 2.0 ** -7)
            kp, vp = kp32.to(kv_dt), vp32.to(kv_dt)
            for sq in (1, 3):
                q = torch.randn((b, heads, sq, d), generator=gen,
                                device=cuda_device).to(q_dt)
                for window, cap in ((None, None), (64, None), (None, 50.0),
                                    (64, 50.0)):
                    args = (q, kp, vp, table, last)
                    kw = dict(window=window, softcap=cap)
                    pops.reset_launch_counts()
                    got = pops.paged_attention(*args, **kw)
                    assert pops.launch_counts()["paged_flash_attention"] == 1
                    assert got.dtype == q_dt
                    want = pref.paged_attention_ref(*args, **kw)
                    torch.testing.assert_close(
                        got.float(), want.float(), atol=atol, rtol=rtol,
                        msg=lambda m: f"d {d} {q_dt}/{kv_dt} sq {sq} {kw}: {m}")
                    assert torch.equal(got,
                                       pops.paged_attention(*args, **kw))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# pool: identical bookkeeping on one random sequence
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool._table.tolist(), np.asarray(pool.page_table).tolist(),
            pool.refs.tolist(), list(pool._free_pages),
            list(pool._free_slots), pool.index.n_nodes)


@needs_jax
def test_pool_matches_jax_on_random_sequence():
    cfg_j, cfg_p = JC.get_smoke(NEMOTRON), PC.get_smoke(NEMOTRON)
    kw = dict(page_size=8, n_pages=10)
    jpool = JPool(cfg_j, 3, 32, jnp.float32, **kw)
    ppool = PagedCachePool(cfg_p, 3, 32, torch.float32, "cpu", **kw)
    rng = np.random.default_rng(0)
    systems = [rng.integers(0, 64, 16) for _ in range(2)]
    live, events = {}, {"exhausted": 0, "evicted": 0, "matched": 0}
    for _ in range(60):
        if live and (not jpool.n_free or rng.random() < 0.4):
            slot = int(rng.choice(sorted(live)))
            conv = np.concatenate([live.pop(slot),
                                   rng.integers(0, 64, rng.integers(1, 9))])
            assert jpool.conversation_insert(conv, slot) \
                == ppool.conversation_insert(conv, slot)
            jpool.free(slot)
            ppool.free(slot)
        else:
            prompt = np.concatenate([systems[rng.integers(2)],
                                     rng.integers(0, 64, rng.integers(1, 9))])
            slot = jpool.alloc()
            assert ppool.alloc() == slot
            match = jpool.prefix_match(prompt)
            assert ppool.prefix_match(prompt) == match
            events["matched"] += match[0] > 0
            n = len(prompt) + int(rng.integers(1, 9))
            evicted = jpool.index.evicted
            try:
                jpool.alloc_pages(slot, n, match[1])
            except JPoolExhausted:
                with pytest.raises(PoolExhausted):
                    ppool.alloc_pages(slot, n, match[1])
                jpool.free(slot)
                ppool.free(slot)
                events["exhausted"] += 1
            else:
                ppool.alloc_pages(slot, n, match[1])
                assert jpool.prefix_insert(prompt, slot) \
                    == ppool.prefix_insert(prompt, slot)
                live[slot] = prompt
            events["evicted"] += jpool.index.evicted - evicted
            assert ppool.index.evicted == jpool.index.evicted
        assert _pool_state(ppool) == _pool_state(jpool)
        assert ppool.page_stats() == jpool.page_stats()
    assert all(events.values()), events       # every path was exercised


@needs_jax
def test_pool_refuses_too_few_pages():
    for pool, cfg, extra in ((JPool, JC.get_smoke(NEMOTRON), ()),
                             (PagedCachePool, PC.get_smoke(NEMOTRON),
                              ("cpu",))):
        with pytest.raises(ValueError, match="cannot hold even one"):
            pool(cfg, 2, 32, *((jnp.float32,) if not extra
                               else (torch.float32, *extra)),
                 page_size=8, n_pages=4)


# ---------------------------------------------------------------------------
# engine: JAX's paged engine vs the port's
# ---------------------------------------------------------------------------

def _trace(vocab):
    """Five requests sharing a 24-token system prompt, then the second
    turn of the first one's conversation (prior prompt + reply + 5 new)."""
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, vocab, 24)
    wave = [np.concatenate([sys_p, rng.integers(0, vocab, 5)])
            for _ in range(5)]
    return wave, rng.integers(0, vocab, 5)


def _serve(eng, vocab):
    wave, follow = _trace(vocab)
    reqs = [eng.submit(p, 5, arrival_step=i) for i, p in enumerate(wave)]
    eng.run()
    conv = np.concatenate([wave[0], np.asarray(reqs[0].generated, np.int32)])
    reqs.append(eng.submit(np.concatenate([conv, follow]), 5,
                           arrival_step=eng.step_count))
    eng.run()
    return ([list(r.generated) for r in reqs],
            [r.prefix_matched for r in reqs], eng.metrics.report())


@functools.lru_cache(maxsize=None)
def _jax_side(arch, name, k):
    """(greedy tokens, prefix_matched, report, flat JAX params)."""
    spec = jkr.KratosSpec(**SPECS[name])
    cfg = JC.get_smoke(arch, kratos=spec)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    model = JRegistry().load(arch, spec, params=params)
    eng = JEngine(model, JEngineConfig(n_slots=2, max_len=64, page_size=8,
                                       decode_chunk=k))
    return (*_serve(eng, cfg.vocab), params)


def _port_engine(arch, name, params, tmp_path, **kw):
    save_pytree(str(tmp_path), params)
    cfg = PC.get_smoke(arch)
    model = ModelRegistry().load(
        arch, pkr.KratosSpec(**SPECS[name]),
        params=convert(str(tmp_path), cfg.n_layers), device="cpu")
    return InferenceEngine(model, EngineConfig(n_slots=2, max_len=64,
                                               device="cpu", **kw))


@needs_jax
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", list(SPECS))
def test_paged_engine_matches_jax(name, k, tmp_path, monkeypatch):
    want_tok, want_matched, want_rep, params = _jax_side(NEMOTRON, name, 1)
    eng = _port_engine(NEMOTRON, name, params, tmp_path, page_size=8,
                       decode_chunk=k)
    reads = _record_decode_host_reads(monkeypatch, eng.backend)
    tok, matched, rep = _serve(eng, PC.get_smoke(NEMOTRON).vocab)
    monkeypatch.undo()
    assert tok == want_tok
    # 4 admissions reuse the system prompt; turn 2 reuses the 4 full pages
    # of its 34-token conversation, the last of them generated
    assert matched == want_matched == [0, 24, 24, 24, 24, 32]
    keys = REUSE_KEYS + (GAUGE_KEYS if k == 1 else ())
    assert {key: rep[key] for key in keys} \
        == {key: want_rep[key] for key in keys}
    assert rep["conversation_prefix_hits"] == 1
    assert rep["conversation_tokens_reused"] == 32
    assert reads == ["cpu"] * int(rep["decode_steps"])
    # pristine drain: only tree-retained pages remain referenced
    pool = eng.pool
    assert pool.n_active == 0 and pool.pages_in_use == pool.index.n_nodes
    pool.index.clear(pool._release)
    assert int(pool.refs[1:].sum()) == 0
    assert len(pool._free_pages) == pool.n_usable_pages


@needs_jax
def test_paged_engine_matches_slab_engine(tmp_path):
    """The port's own paged and slab engines agree token for token."""
    *_, params = _jax_side(NEMOTRON, "w4", 1)
    out = []
    for kw in (dict(page_size=8), {}):
        eng = _port_engine(NEMOTRON, "w4", params, tmp_path, decode_chunk=2,
                           **kw)
        out.append(_serve(eng, PC.get_smoke(NEMOTRON).vocab)[0])
    assert out[0] == out[1]


@needs_jax
def test_windowed_arch_pages_nothing_and_matches_jax(tmp_path):
    """h2o-danube's window-8 leaves are shorter than max_len: they stay
    resident in the store, the prefix index is off, and the paged engine
    still gives JAX's tokens."""
    want_tok, want_matched, want_rep, params = _jax_side(DANUBE, "dense", 2)
    eng = _port_engine(DANUBE, "dense", params, tmp_path, page_size=8,
                       decode_chunk=2)
    assert not prefix_supported(eng.model.cfg)
    assert eng.pool.index is None and not eng.pool.layout.has_paged
    assert tuple(eng.pool.store[0]["k"].shape) == (2, 2, 8, 8)
    tok, matched, rep = _serve(eng, PC.get_smoke(DANUBE).vocab)
    assert tok == want_tok
    assert matched == want_matched == [0] * 6
    assert rep["prefix_hit_rate"] == want_rep["prefix_hit_rate"] == 0.0


@needs_jax
def test_paged_window_bounds_requests_at_max_len():
    """h2o-danube's window-8 leaves are paged once max_len is no longer
    than the window, and the pool's table then ends at max_len: the port
    refuses a request past it at submit, where the slab (a circular
    window) serves it. JAX's paged engine accepts it and clamps its table
    lookup at the slot's last page; the port departs from that on
    purpose."""
    cfg = PC.get_smoke(DANUBE)
    assert cfg.window == 8
    model = ModelRegistry().load(DANUBE, device="cpu")
    paged = InferenceEngine(model, EngineConfig(
        n_slots=2, max_len=8, page_size=4, device="cpu"))
    slab = InferenceEngine(model, EngineConfig(n_slots=2, max_len=8,
                                               device="cpu"))
    jeng = JEngine(JRegistry().load(DANUBE),
                   JEngineConfig(n_slots=2, max_len=8, page_size=4))
    assert paged.pool.layout.has_paged and paged._len_bounded
    assert not slab._len_bounded and not jeng._len_bounded
    prompt = np.arange(6, dtype=np.int32)
    with pytest.raises(ValueError, match="max_len"):
        paged.submit(prompt, 3)
    paged.submit(prompt, 2)
    slab.submit(prompt, 3)
    jeng.submit(prompt, 3)


@needs_jax
def test_pool_pressure_requeues_and_release_parks_slot(tmp_path):
    """With pages for one request at a time, the second admission bounces
    (pool_waits), is requeued at the front and completes after the first
    frees its pages. release_slot parks a running slot's loop row."""
    *_, params = _jax_side(NEMOTRON, "dense", 1)
    eng = _port_engine(NEMOTRON, "dense", params, tmp_path, page_size=8,
                       n_pages=9, prefix_cache=False)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, 256, 30), 20) for _ in range(2)]
    eng.step()
    slot = reqs[0].slot
    assert bool(eng.backend.state["active"][slot])
    eng.run()
    assert eng.metrics.report()["pool_waits"] >= 1
    assert all(len(r.generated) == 20 for r in reqs)
    eng.submit(rng.integers(0, 256, 10), 5)
    eng.step()
    eng.backend.release_slot(eng.requests[2].slot)
    st = eng.backend.state
    assert not bool(st["active"][eng.requests[2].slot])
    assert int(st["remaining"][eng.requests[2].slot]) == 0


def test_paged_config_checks():
    with pytest.raises(ValueError, match="page_size must be >= 1"):
        EngineConfig(device="cpu", page_size=0)
    with pytest.raises(ValueError, match="n_pages without page_size"):
        EngineConfig(device="cpu", n_pages=8)


def test_paged_writes_land_as_a_sequential_write():
    """Writes aimed twice at one row (the sink page: parked slots, positions
    past a slot's pages) all carry the value of the last of them, so the
    page store ends as a sequential write leaves it on any device; the
    admission scatter does the same over a table row's sink entries."""
    from repro_torch.models.attention import paged_writes
    from repro_torch.serve.paging import PageLayout
    # targets 1, 26, 1, 44, 2, 26: the last write to 1 is #2, to 26 is #5
    assert pref.last_write(torch.tensor([1, 26, 1, 44, 2, 26])).tolist() \
        == [2, 5, 2, 3, 4, 5]
    # slots 0 and 2 parked on the sink (page 0), slot 1 live at position
    # 9 (page 3, row 1): the plan every attention layer of a forward uses
    w = paged_writes({"size": 8, "len": 16,
                      "table": torch.tensor([[0, 0], [2, 3], [0, 0]],
                                            dtype=torch.int32)},
                     torch.tensor([5, 9, 5], dtype=torch.int32), 3, 1)
    assert w["page"].tolist() == [[0], [3], [0]]
    assert w["off"].tolist() == [[5], [1], [5]]
    assert w["last"].tolist() == [5, 9, 5] and w["src"].tolist() == [2, 1, 2]
    assert paged_writes(w, None, 3, 1) is w
    cfg = PC.get_smoke("nemotron-4-340b")
    layout = PageLayout(cfg, 2, 32, 8, device="cpu")
    leaf = torch.zeros((6, 2, 8, 16))
    slab = torch.arange(2 * 32 * 16, dtype=torch.float32).reshape(1, 2, 32, 16)
    layout._scatter_leaf(leaf, torch.tensor([[4, 2, 0, 0]], dtype=torch.int32),
                         slab)
    assert torch.equal(leaf[4], slab[0, :, 0:8])
    assert torch.equal(leaf[2], slab[0, :, 8:16])
    assert torch.equal(leaf[0], slab[0, :, 24:32])     # the last sink entry
