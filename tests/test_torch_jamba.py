"""Port parity, the jamba hybrid (jamba-v0.1-52b): Mamba-1 mixers, one
attention mixer without RoPE in every 8-layer block, MoE at odd layers and
a dense MLP at the rest.

On the CPU, with numpy inputs from a seed and JAX weights carried across
through `save_pytree` and `checkpoint.convert`:
  * `layer_kind`, `param_count` (51.6 B at 32 layers) and `layer_order`
    (scan_period 8: each slot's stack in turn) against JAX's configs;
  * the smoke forward (prefill, then decode with per-slot clocks) against
    JAX `T.forward` under `ref` and Pallas `interpret`, dense and s0.5-w8,
    within 1e-4 on the logits;
  * greedy engine tokens equal JAX's engine on the slab (K 1 and 4) and
    through the page pool, where the attention layer's k/v are paged and
    the Mamba layers' conv/ssm state stays resident; prompts prefill at
    exact length, a request past max_len is refused, prefix reuse is off;
  * where decode drops expert assignments (capacity factor 1.0) the slab
    and the page pool part, in JAX's engines as in the port's, and each of
    the port's equals JAX's;
  * (speculative decode of the arch is held to JAX's in
    tests/test_torch_spec_families.py and test_torch_speculative.py);
  * `load` packs leaf by leaf: the same packed tree and counts, with each
    float leaf let go as it packs.
A `cuda`-marked test serves the smoke model on the card with every decode
dispatch a graph replay against the same engine stepping eagerly."""

import dataclasses
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
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.core import kratos as jkr
    from repro.models import transformer as JT
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.models import transformer as PT
from repro_torch.serve import (EngineConfig, InferenceEngine, ModelRegistry,
                               prefix_supported)
from repro_torch.serve.registry import PACKABLE, pack_model_params

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
ARCH = "jamba-v0.1-52b"
SPECS = {"dense": {}, "s0.5w8": dict(sparsity=0.5, bits=8, bk=8, bn=8)}
# (prompt length, new tokens): lengths off every pow2 bucket
JOBS = ((5, 7), (11, 6), (9, 9))
N_SLOTS, MAX_LEN = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4, err_msg=msg)


def _jobs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0).astype(np.int32), g) for s0, g in JOBS]


def _run(eng, jobs):
    reqs = [eng.submit(p, g, arrival_step=i) for i, (p, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _carried(name="dense"):
    cfg = JC.get_smoke(ARCH, kratos=jkr.KratosSpec(**SPECS[name]))
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported


def _port_model(name="dense"):
    return ModelRegistry().load(ARCH, pkr.KratosSpec(**SPECS[name]),
                                params=_carried(name)[2], device="cpu")


@needs_jax
def test_layer_kind_param_count_and_order_match_jax():
    for get in ("get_config", "get_smoke"):
        jcfg, pcfg = getattr(JC, get)(ARCH), getattr(PC, get)(ARCH)
        assert [PT.layer_kind(pcfg, i) for i in range(pcfg.n_layers)] == \
            [JT.layer_kind(jcfg, i) for i in range(jcfg.n_layers)]
        assert pcfg.param_count() == jcfg.param_count()
        # the JAX package runs slot s's stack (layers s, s + 8, ...) in turn
        p, n = jcfg.scan_period, jcfg.n_layers
        assert PT.layer_order(pcfg) == [t * p + s for s in range(p)
                                        for t in range(n // p)]
    full = PC.get_config(ARCH)
    assert full.param_count() == 51_569_590_272
    kinds = [PT.layer_kind(full, i) for i in range(8)]
    assert [k["mixer"] for k in kinds] == ["mamba"] * 4 + ["attn"] \
        + ["mamba"] * 3
    assert [k["ffn"] for k in kinds] == ["mlp", "moe"] * 4
    assert not full.use_rope
    # one Jamba block is the smallest depth scan_period 8 allows
    cut = dataclasses.replace(full, n_layers=8)
    assert PT.layer_order(cut) == list(range(8))
    assert cut.param_count() == 13_295_050_752
    with pytest.raises(ValueError, match="scan_period"):
        PT.layer_order(dataclasses.replace(full, n_layers=12))


@needs_jax
def test_convert_carries_the_hybrid_checkpoint():
    """Every layer gets its own kind's parameters from its slot's stack,
    and the packed model counts each projection once: 4 attention
    projections, 3 Mamba projections (dt_proj stays a plain matmul) on 7
    layers, and the 3 MLP projections of the 4 dense-FFN layers."""
    _, _, ported = _carried()
    cfg = PC.get_smoke(ARCH)
    for i, layer in enumerate(ported["layers"]):
        kind = PT.layer_kind(cfg, i)
        assert ("wq" in layer["mixer"]) == (kind["mixer"] == "attn")
        assert ("in_proj" in layer["mixer"]) == (kind["mixer"] == "mamba")
        assert ("router" in layer["ffn"]) == (kind["ffn"] == "moe")
    model = _port_model()
    assert model.n_packed == 4 + 3 * 7 + 3 * 4


@needs_jax
@pytest.mark.parametrize("backend,name", [("ref", "dense"),
                                          ("interpret", "dense"),
                                          ("ref", "s0.5w8"),
                                          ("interpret", "s0.5w8")])
def test_forward_matches_jax(backend, name):
    """Prefill 10 tokens, then 4 decode steps with per-slot clocks, against
    jax.jit of JAX's forward (the reference serves jitted: its expert
    fake-quant is the jitted one)."""
    cfg, params, _ = _carried(name)
    model = _port_model(name)
    b, s0, max_len = 3, 10, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
        .astype(np.int32)
    jprefill = jax.jit(lambda p, t, c: JT.forward(p, t, cfg, caches=c,
                                                  backend=backend))
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(
        p, t, cfg, caches=c, index=i, backend=backend))
    jc = JT.make_caches(cfg, b, max_len, jnp.float32)
    jlog, _, jc = jprefill(params, jnp.asarray(tokens), jc)
    pc = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
    assert set(pc[4]) == {"k", "v"} and set(pc[0]) == {"conv", "ssm"}
    plog, pc = PT.forward(model.params, _t(tokens), model.cfg, caches=pc)
    _close(plog, jlog, f"{name} prefill")
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    for step in range(4):
        index = np.array([s0 + step, s0 + step - 2, s0 + step - 5], np.int32)
        jlog, _, jc = jdecode(params, jnp.asarray(tok[:, None]), jc,
                              jnp.asarray(index))
        plog, pc = PT.forward(model.params, _t(tok[:, None]), model.cfg,
                              caches=pc, index=_t(index))
        _close(plog, jlog, f"{name} decode {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tokens(name, **kw):
    cfg, params, _ = _carried(name)
    model = JRegistry().load(ARCH, jkr.KratosSpec(**SPECS[name]),
                             params=params)
    eng = JEngine(model, JEngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                       **kw))
    return _run(eng, _jobs(cfg.vocab))


@needs_jax
@pytest.mark.parametrize("name,k", [("dense", 1), ("dense", 4),
                                    ("s0.5w8", 2)])
def test_slab_engine_matches_jax(name, k, monkeypatch):
    """Greedy tokens equal JAX's engine; every prompt prefills at its exact
    length (pad tokens would enter the recurrence and take expert
    capacity)."""
    eng = InferenceEngine(_port_model(name), EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=k, device="cpu"))
    assert eng._exact_prefill and eng._len_bounded
    prefill = eng.backend.prefill
    lengths = []
    monkeypatch.setattr(eng.backend, "prefill", lambda batch, exact: (
        lengths.append((batch["tokens"].shape[1], exact)),
        prefill(batch, exact))[1])
    assert _run(eng, _jobs(256)) == _jax_tokens(name, decode_chunk=k)
    assert lengths == [(s0, True) for s0, _ in JOBS]


@needs_jax
def test_paged_engine_matches_jax():
    """Through the page pool (page 8) the attention layer's k/v are paged
    and the Mamba layers' conv/ssm state stays resident by name; there is
    no prefix index (a recurrent state cannot be shared by pages), and the
    tokens equal JAX's paged engine's and the slab's."""
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2, page_size=8,
        device="cpu"))
    layout = eng.pool.layout
    cfg = eng.model.cfg
    for i, paged in enumerate(layout.paged):
        if PT.layer_kind(cfg, i)["mixer"] == "attn":
            assert paged == {"k": True, "v": True}
        else:
            assert paged == {"conv": False, "ssm": False}
    assert eng.pool.index is None and not prefix_supported(cfg)
    got = _run(eng, _jobs(256))
    assert got == _jax_tokens("dense", decode_chunk=2, page_size=8)
    assert got == _jax_tokens("dense", decode_chunk=2)
    rep = eng.metrics.report()
    assert rep["prefill_tokens_skipped"] == 0


@needs_jax
def test_engines_part_where_decode_drops():
    """At capacity factor 1.0 a decode step of 4 slots routes C = 2 rows an
    expert (top 2 of 4) and drops assignments. A parked slot's row routes
    with the live ones: it reads its stale slab row on the slab but the
    sink page in the pool, so the two pools drop differently and their
    tokens part. The port's slab tokens equal JAX's slab engine's, its
    paged tokens JAX's paged engine's, and JAX's two engines part as the
    port's do."""
    cfg, params, _ = _carried()
    want = {}
    for page_size in (None, 8):
        jm = JRegistry().load(ARCH, params=params)
        jm = dataclasses.replace(jm, cfg=dataclasses.replace(
            jm.cfg, capacity_factor=1.0))
        want[page_size] = _run(JEngine(jm, JEngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2,
            page_size=page_size)), _jobs(cfg.vocab))
        pm = _port_model()
        pm = dataclasses.replace(pm, cfg=dataclasses.replace(
            pm.cfg, capacity_factor=1.0))
        got = _run(InferenceEngine(pm, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2,
            page_size=page_size, device="cpu")), _jobs(256))
        assert got == want[page_size], page_size
    assert want[None] != want[8]


@needs_jax
def test_request_past_max_len_refused():
    """The attention layer's cache is positional: the hybrid is bounded by
    max_len, as in the JAX package."""
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=2, max_len=MAX_LEN, device="cpu"))
    jeng = JEngine(JRegistry().load(ARCH, params=_carried()[1]),
                   JEngineConfig(n_slots=2, max_len=MAX_LEN))
    prompt = np.arange(20, dtype=np.int32)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="max_len"):
            e.submit(prompt, MAX_LEN - 19)
        e.submit(prompt, MAX_LEN - 20)


@needs_jax
@pytest.mark.parametrize("name", list(SPECS))
def test_load_packs_leaf_by_leaf(name):
    """pack_model_params(consume=True), which `load` runs on its own tree,
    gives the tree and count of the plain walk and leaves the source
    without its projection weights and routed stacks, so each float leaf
    can free as soon as it is packed; `load`'s counts are unchanged."""
    spec = pkr.KratosSpec(**SPECS[name])
    want, n_want = pack_model_params(_carried()[2], spec)
    src = _clone(_carried()[2])
    got, n_got = pack_model_params(src, spec, consume=True)
    assert n_got == n_want
    _same(got, want, "params")
    for layer in src["layers"]:
        for module in (layer["mixer"], layer["ffn"]):
            for k in PACKABLE & set(module):
                assert module[k] == {}, k
        assert set(layer["mixer"].get("dt_proj", {"w": 0, "b": 0})) == \
            {"w", "b"}                   # a plain matmul, never packed
        if "router" in layer["ffn"]:
            assert set(layer["ffn"]) == {"router"}
    model = _port_model(name)
    again = ModelRegistry().load(ARCH, spec, params=_carried(name)[2],
                                 device="cpu", name="again")
    assert (model.n_packed, model.packed_bytes, model.dense_bytes) == \
        (again.n_packed, again.packed_bytes, again.dense_bytes)
    _same(model.params, again.params, "load")
    assert _carried(name)[2]["layers"][0]["mixer"]["in_proj"]["w"].ndim == 2


def _clone(node):
    if isinstance(node, dict):
        return {k: _clone(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_clone(v) for v in node]
    return node.clone()


def _same(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name),
                  f"{where}.{f.name}")
    else:
        assert got == want, where


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, 8])
@pytest.mark.parametrize("name", ["dense", "s0.5"])
def test_cuda_graph_replay_matches_eager(cuda_device, name, page_size):
    """The smoke jamba served with every decode dispatch a graph replay
    against the same engine stepping eagerly, slab and paged: greedy tokens
    equal. Parked slots read the sink page and route with the live rows, so
    the sink's content must not depend on the order of the card's writes;
    under s0.5 (bk = bn = 16) a replay counts the batched expert kernel once
    per MoE projection and the scan never (decode is the recurrence)."""
    spec = pkr.KratosSpec(**({} if name == "dense"
                             else dict(sparsity=0.5, bk=16, bn=16)))
    jobs = [(np.random.default_rng(i).integers(0, 256, s0).astype(np.int32),
             g) for i, (s0, g) in enumerate(((5, 7), (11, 3), (9, 12),
                                             (3, 9), (14, 5), (6, 8)))]
    out = []
    for eager in (False, True):
        model = ModelRegistry().load(ARCH, spec, device="cuda")
        eng = InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2,
            page_size=page_size))
        if eager:
            eng.backend._graph = None
        else:
            launches = eng.backend._graph_launches
            assert launches.get("bsr_matmul_experts", 0) == \
                (2 * 4 * 3 if name == "s0.5" else 0)
            assert launches.get("ssm_scan", 0) == 0
        out.append(_run(eng, jobs))
    assert out[0] == out[1]
