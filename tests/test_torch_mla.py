"""Port parity, MLA (multi-head latent attention; minicpm3-4b).

On the CPU, with numpy inputs from a seed and JAX weights carried across:
  * `mla_apply` against JAX's in every cache mode: no cache, prefill into
    the cache, slab decode with a scalar clock and with per-slot clocks,
    the speculative block write (s > 1), and native paged decode (latents
    written into their pages, attention on the sliced table view); output
    and caches within 1e-4, with q_lora_rank set and with it None;
  * `attention_chunked` against `attention_positional` and JAX's;
  * the pack-time format of every MLA leaf (`serving_spec`, the block
    plan, the buffers packed) equal to `repro.core.kratos`'s under
    s0.5-w8, w4 and w8a8, at the full config's shapes and the smoke's;
  * `layer_kind` / `param_count` and the smoke forward (prefill and
    decode) against JAX `T.forward`;
  * greedy engine tokens equal JAX's engine: slab (dense and s0.5-w8, K 1
    and 4), paged with prefix and conversation reuse (prefix_matched and
    the skipped counts equal JAX's), speculative decode with K in
    {1, 2, 4} on the slab and paged.
`cuda`-marked tests hold the GEMMs at MLA's shapes to their plain versions
and a graphed minicpm3 engine to the eager step on the card."""

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
    from repro.models import attention as JA
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry
    from repro.serve.registry import pack_model_params as jpack

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                               ModelRegistry, PagedCachePool)
from repro_torch.serve.registry import pack_model_params

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
MINICPM = "minicpm3-4b"
SPECS = {"dense": {}, "s0.5w8": dict(sparsity=0.5, bits=8, bk=8, bn=8),
         "w4": dict(bits=4), "w8a8": dict(bits=8, act_bits=8)}
JOBS = ((5, 7), (11, 6), (9, 9), (3, 4))
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jobs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0).astype(np.int32), g) for s0, g in JOBS]


def _run(eng, jobs):
    reqs = [eng.submit(p, g, arrival_step=i) for i, (p, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs]


# ---------------------------------------------------------------------------
# mla_apply, every cache mode
# ---------------------------------------------------------------------------

def _attn_cfgs(q_lora):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, mla=True,
              q_lora_rank=q_lora, kv_lora_rank=16, qk_nope_dim=16,
              qk_rope_dim=8, v_head_dim=16)
    return JA.AttnConfig(**kw), PA.AttnConfig(**kw)


def _mla_params(jcfg):
    """(JAX {"w"} params, the port's packed params) on the same weights."""
    jp = JA.mla_init(jax.random.PRNGKey(1), jcfg)
    dense = jax.tree_util.tree_map(lambda a: _t(a), jp)
    return jp, pack_model_params(dense, pkr.DENSE)[0]


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4, err_msg=msg)


@needs_jax
@pytest.mark.parametrize("q_lora", [32, None], ids=["q_lora", "no_q_lora"])
def test_mla_apply_every_cache_mode(q_lora):
    jcfg, pcfg = _attn_cfgs(q_lora)
    jp, pp = _mla_params(jcfg)
    assert ("wq_a" in pp) == bool(q_lora) and ("wq" in pp) != bool(q_lora)
    b, s0, max_len = 2, 10, 24
    x = rnd(0, (b, s0, 64))

    # no cache: the training-shaped full sequence
    jy, _ = JA.mla_apply(jp, jnp.asarray(x), jcfg)
    py, _ = PA.mla_apply(pp, _t(x), pcfg)
    _close(py, jy, "no cache")

    # prefill into the cache
    jc = JA.make_mla_cache(jcfg, b, max_len, jnp.float32)
    pc = PA.make_mla_cache(pcfg, b, max_len, torch.float32, "cpu")
    jy, jc = JA.mla_apply(jp, jnp.asarray(x), jcfg, cache=jc)
    py, pc = PA.mla_apply(pp, _t(x), pcfg, cache=pc)
    _close(py, jy, "prefill")
    for n in ("c_kv", "k_rope"):
        _close(pc[n], jc[n], f"prefill {n}")

    # slab decode: scalar clock, per-slot clocks, block writes (s = 3)
    steps = [(10, 1), (np.array([11, 7], np.int32), 1), (12, 3),
             (np.array([15, 8], np.int32), 3)]
    for i, (index, s) in enumerate(steps):
        xs = rnd(10 + i, (b, s, 64))
        jidx = jnp.asarray(index, jnp.int32)
        jy, jc = JA.mla_apply(jp, jnp.asarray(xs), jcfg, cache=jc,
                              index=jidx)
        py, pc = PA.mla_apply(pp, _t(xs), pcfg, cache=pc,
                              index=_t(np.asarray(index, np.int32)))
        _close(py, jy, f"decode {i}")
        for n in ("c_kv", "k_rope"):
            _close(pc[n], jc[n], f"decode {i} {n}")

    # native paged decode: the slab above laid out in pages of 4 behind a
    # permuted table, then decode s = 1 and the s = 3 block through it
    page, pp_ = 4, max_len // 4
    n_pages = b * pp_ + 1
    table = (np.random.default_rng(3).permutation(n_pages - 1) + 1) \
        .reshape(b, pp_).astype(np.int32)
    slab = {n: np.asarray(jc[n]) for n in ("c_kv", "k_rope")}
    jstore = {"c_kv": np.zeros((n_pages, page, 16), np.float32),
              "k_rope": np.zeros((n_pages, 1, page, 8), np.float32)}
    for bi in range(b):
        for j in range(pp_):
            rows = slice(j * page, (j + 1) * page)
            jstore["c_kv"][table[bi, j]] = slab["c_kv"][bi, rows]
            jstore["k_rope"][table[bi, j]] = slab["k_rope"][bi, :, rows]
    pstore = {n: _t(a) for n, a in jstore.items()}
    jstore = {n: jnp.asarray(a) for n, a in jstore.items()}
    pages = {"size": page, "len": max_len}
    for i, (index, s) in enumerate([(np.array([18, 11], np.int32), 1),
                                    (np.array([19, 12], np.int32), 3)]):
        xs = rnd(20 + i, (b, s, 64))
        jy, jstore = JA.mla_apply(jp, jnp.asarray(xs), jcfg, cache=jstore,
                                  index=jnp.asarray(index),
                                  pages=dict(pages, table=jnp.asarray(table)))
        py, pstore = PA.mla_apply(pp, _t(xs), pcfg, cache=pstore,
                                  index=_t(index),
                                  pages=dict(pages, table=_t(table)))
        _close(py, jy, f"paged {i}")
        for n in ("c_kv", "k_rope"):
            _close(pstore[n], jstore[n], f"paged {i} {n}")


@needs_jax
def test_attention_chunked_matches_positional_and_jax():
    b, h, s, d = 1, 2, 37, 8
    q, k, v = rnd(1, (b, h, s, d)), rnd(2, (b, h, s, d)), rnd(3, (b, h, s, 4))
    pos = np.arange(s, dtype=np.int32)
    kw = dict(causal=True, window=None, softcap=None, scale=0.3)
    want = JA.attention_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                chunk=8, **kw)
    got = PA.attention_chunked(*map(_t, (q, k, v, pos, pos)), chunk=8, **kw)
    full = PA.attention_positional(*map(_t, (q, k, v, pos, pos)), **kw)
    _close(got, want)
    torch.testing.assert_close(got, full, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# pack-time format of every MLA leaf
# ---------------------------------------------------------------------------

def _full_mla_shapes(cfg):
    h, qd = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim
    return {"wq_a": (cfg.d_model, cfg.q_lora_rank),
            "wq_b": (cfg.q_lora_rank, h * qd),
            "wq": (cfg.d_model, h * qd),
            "wkv_a": (cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
            "wkv_b": (cfg.kv_lora_rank,
                      h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            "wo": (h * cfg.v_head_dim, cfg.d_model)}


@needs_jax
@pytest.mark.parametrize("name", ["s0.5w8", "w4", "w8a8"])
def test_pack_time_format_matches_jax(name):
    # the full config at the default 128 block grid: wkv_a's 288 columns and
    # wkv_b's k = 256 against the grid and the code packing
    full = dict(SPECS[name], bk=128, bn=128) if "sparsity" in SPECS[name] \
        else SPECS[name]
    jspec, pspec = jkr.KratosSpec(**full), pkr.KratosSpec(**full)
    shapes = _full_mla_shapes(PC.get_config(MINICPM))
    assert shapes["wkv_a"] == (2560, 288) and shapes["wkv_b"] == (256, 5120)
    for leaf, (n_in, n_out) in shapes.items():
        js, ps = jkr.serving_spec(n_in, n_out, jspec), \
            pkr.serving_spec(n_in, n_out, pspec)
        assert (ps.bits, ps.act_bits, ps.sparsity) == \
            (js.bits, js.act_bits, js.sparsity), leaf
        assert (pkr.plan_for(n_in, n_out, ps) is None) == \
            (jkr.plan_for(n_in, n_out, js) is None), leaf
    if "sparsity" in full:
        # off the 128 grid: wkv_a stays dense-structured (w8 codes)
        assert pkr.plan_for(2560, 288, pspec) is None
    # the smoke model packed by both registries: the same buffers per leaf
    spec = SPECS[name]
    cfg = JC.get_smoke(MINICPM, kratos=jkr.KratosSpec(**spec))
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    jtree = jpack(params, jkr.KratosSpec(**spec))[0]
    ptree = ModelRegistry().load(MINICPM, pkr.KratosSpec(**spec),
                                 params=ported, device="cpu").params
    for li, layer in enumerate(ptree["layers"]):
        jmix = jtree["blocks"][0]["mixer"]
        for leaf in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
            got, want = layer["mixer"][leaf], jmix[leaf]
            assert isinstance(got, pkr.PackedLinear), leaf
            assert set(got.buffers) == set(want.buffers), (li, leaf)
            assert got.spec.bits == want.spec.bits, (li, leaf)
        assert set(layer["mixer"]["q_norm"]) == {"scale"}    # a norm, kept
        assert set(layer["mixer"]["kv_norm"]) == {"scale"}


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _carried(name="dense"):
    cfg = JC.get_smoke(MINICPM, kratos=jkr.KratosSpec(**SPECS[name]))
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported


def _port_model(name="dense", draft_spec=None):
    return ModelRegistry().load(MINICPM, pkr.KratosSpec(**SPECS[name]),
                                params=_carried(name)[2], device="cpu",
                                draft_spec=draft_spec)


@needs_jax
def test_layer_kind_param_count_and_forward_match_jax():
    for get in ("get_config", "get_smoke"):
        jcfg, pcfg = getattr(JC, get)(MINICPM), getattr(PC, get)(MINICPM)
        assert [PT.layer_kind(pcfg, i) for i in range(pcfg.n_layers)] == \
            [JT.layer_kind(jcfg, i) for i in range(jcfg.n_layers)]
        assert pcfg.param_count() == jcfg.param_count()
    assert PC.get_config(MINICPM).param_count() == 4_073_492_480
    cfg, params, _ = _carried()
    model = _port_model()
    b, s0, max_len = 2, 10, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
        .astype(np.int32)
    jc = JT.make_caches(cfg, b, max_len, jnp.float32)
    jlog, _, jc = JT.forward(params, jnp.asarray(tokens), cfg, caches=jc)
    pc = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
    assert set(pc[0]) == {"c_kv", "k_rope"}
    plog, pc = PT.forward(model.params, _t(tokens), model.cfg, caches=pc)
    _close(plog, jlog, "prefill")
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    for step in range(6):
        index = np.array([s0 + step, s0 + step - 2], np.int32)
        jlog, _, jc = JT.forward(params, jnp.asarray(tok[:, None]), cfg,
                                 caches=jc, index=jnp.asarray(index))
        plog, pc = PT.forward(model.params, _t(tok[:, None]), model.cfg,
                              caches=pc, index=_t(index))
        _close(plog, jlog, f"decode {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tokens(name="dense", speculate=0, **kw):
    cfg, params, _ = _carried(name)
    model = JRegistry().load(MINICPM, jkr.KratosSpec(**SPECS[name]),
                             params=params,
                             draft_spec=JDraftSpec(bits=8) if speculate
                             else None)
    eng = JEngine(model, JEngineConfig(n_slots=3, max_len=MAX_LEN,
                                       speculate=speculate, **kw))
    return _run(eng, _jobs(cfg.vocab))


@needs_jax
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["dense", "s0.5w8"])
def test_slab_engine_matches_jax(name, k):
    eng = InferenceEngine(_port_model(name), EngineConfig(
        n_slots=3, max_len=MAX_LEN, decode_chunk=k, device="cpu"))
    assert eng._len_bounded
    assert _run(eng, _jobs(256)) == _jax_tokens(name, decode_chunk=k)
    with pytest.raises(ValueError, match="max_len=32"):
        eng.submit(np.arange(30), 3)


def _serve_prefix(eng, vocab):
    """Four requests under a shared 16-token system prompt, then the
    second turn of the first conversation (its 27 tokens publish 3 pages,
    one past the prompt's)."""
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, vocab, 16)
    wave = [np.concatenate([sys_p, rng.integers(0, vocab, 3)])
            for _ in range(4)]
    reqs = [eng.submit(p, 8, arrival_step=i) for i, p in enumerate(wave)]
    eng.run()
    conv = np.concatenate([wave[0], np.asarray(reqs[0].generated, np.int32)])
    reqs.append(eng.submit(np.concatenate([conv, rng.integers(0, vocab, 3)]),
                           4, arrival_step=eng.step_count))
    eng.run()
    return ([list(r.generated) for r in reqs],
            [r.prefix_matched for r in reqs], eng.metrics.report())


REUSE_KEYS = ("prefix_hit_rate", "prefill_skip_fraction",
              "prefill_tokens_skipped", "conversation_prefix_hits",
              "conversation_tokens_reused", "requests_completed")


@needs_jax
@pytest.mark.parametrize("k", [1, 2])
def test_paged_prefix_reuse_matches_jax(k):
    """c_kv and k_rope are page-major (n_pages, P, r) / (n_pages, 1, P, dr)
    leaves; a matched admission prefills only the suffix through the
    shared latent pages, and tokens and reuse counters equal JAX's."""
    cfg, params, _ = _carried()
    jeng = JEngine(JRegistry().load(MINICPM, params=params), JEngineConfig(
        n_slots=2, max_len=48, page_size=8, decode_chunk=k))
    want_tok, want_matched, want_rep = _serve_prefix(jeng, cfg.vocab)
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=2, max_len=48, page_size=8, decode_chunk=k, device="cpu"))
    assert eng.pool.index is not None
    assert [tuple(t.shape) for t in eng.pool.store[0].values()] == \
        [(13, 8, 16), (13, 1, 8, 8)]
    tok, matched, rep = _serve_prefix(eng, cfg.vocab)
    assert tok == want_tok
    assert matched == want_matched == [0, 16, 16, 16, 24]
    assert {key: rep[key] for key in REUSE_KEYS} == \
        {key: want_rep[key] for key in REUSE_KEYS}
    assert rep["conversation_prefix_hits"] == 1
    slab = InferenceEngine(_port_model(), EngineConfig(
        n_slots=2, max_len=48, decode_chunk=k, device="cpu"))
    assert _serve_prefix(slab, cfg.vocab)[0] == tok


@needs_jax
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("page_size", [None, 8])
def test_speculative_matches_plain_and_jax(k, page_size):
    """MLA's latents are positional: rollback is a clock rewind (no
    recurrent leaf), and the w8 draft re-packs the MLA factors as the
    target's are packed."""
    kw = dict(n_slots=3, max_len=MAX_LEN, device="cpu", page_size=page_size)
    plain = _run(InferenceEngine(_port_model(), EngineConfig(**kw)),
                 _jobs(256))
    model = _port_model(draft_spec=DraftSpec(bits=8))
    dmix = model.draft_params["layers"][0]["mixer"]
    assert all("qt" in dmix[leaf].buffers
               for leaf in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"))
    eng = InferenceEngine(model, EngineConfig(speculate=k, **kw))
    assert not any(n in ("conv", "ssm") for layer in eng.pool.store
                   for n in layer) if page_size else True
    got = _run(eng, _jobs(256))
    assert got == plain == _jax_tokens(speculate=k, page_size=page_size)
    assert eng.metrics.report()["spec_dispatches"] > 0


def test_store_layout_and_paged_view_of_latents():
    """The page pool lays MLA's two leaves out page-major and `paged_view`
    reads either back in position order."""
    cfg = PC.get_smoke(MINICPM)
    pool = PagedCachePool(cfg, 2, 16, torch.float32, "cpu", page_size=4)
    assert all(all(layer.values()) for layer in pool.layout.paged)
    pages = torch.arange(9 * 4 * 3, dtype=torch.float32).reshape(9, 4, 3)
    table = torch.tensor([[3, 1, 8, 2]], dtype=torch.int32)
    view = pref.paged_view(pages, table)
    assert tuple(view.shape) == (1, 16, 3)
    assert torch.equal(view[0], torch.cat([pages[p] for p in (3, 1, 8, 2)]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plain_packed(lin, x):
    """The plain version of the kernel `apply_packed` picks for `lin`."""
    b = lin.buffers
    if "w" in b:
        return pref.dense_matmul_ref(x, b["w"])
    if "qt" in b:
        if lin.spec.act_bits == 8:
            return pref.quant_matmul_w8a8_ref(x, b["qt"])
        return pref.quant_matmul_ref(x, b["qt"])
    if "blocks" in b:
        return pref.bsr_matmul_ref(x, b["blocks"], lin.indices)
    return pref.bsr_quant_matmul_ref(x, b["qblocks"], b["qscale"],
                                     lin.indices, lin.spec.bits)


@pytest.mark.cuda
def test_cuda_gemms_at_mla_shapes(cuda_device):
    """The five GEMMs at minicpm3's MLA shapes against their plain versions
    on the card: wq_a, wq_b, wkv_a (n 288, off the 128 grid: no block
    plan) and wkv_b (k 256), at m = 8 and, for wkv_b, the naive expansion's
    m = 8 x 544; f32 at 1e-4, w8a8 bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(2560, 768, 8), (768, 3840, 8), (2560, 288, 8),
             (2560, 288, 512), (256, 5120, 8), (256, 5120, 8 * 544)]
    specs = [pkr.KratosSpec(), pkr.KratosSpec(bits=4),
             pkr.KratosSpec(bits=8, act_bits=8),
             pkr.KratosSpec(sparsity=0.5), pkr.KratosSpec(sparsity=0.5,
                                                          bits=8)]
    seen = set()
    for n_in, n_out, m in cases:
        w = torch.randn((n_in, n_out), generator=gen,
                        device=cuda_device) * n_in ** -0.5
        x = torch.randn((m, n_in), generator=gen, device=cuda_device)
        for spec in specs:
            lin = pkr.pack_linear({"w": w}, spec)
            pops.reset_launch_counts()
            got = pkr.apply_packed(lin, x)
            ran = [k for k, c in pops.launch_counts().items() if c]
            assert len(ran) == 1, ran
            seen.add(ran[0])
            want = _plain_packed(lin, x)
            if ran[0] == "quant_matmul_w8a8":
                assert torch.equal(got, want), (n_in, n_out, m)
            else:
                torch.testing.assert_close(
                    got, want, atol=1e-4, rtol=1e-4,
                    msg=lambda s: f"{ran[0]} {n_in}x{n_out} m {m}: {s}")
    assert seen == {"dense_matmul", "quant_matmul", "quant_matmul_w8a8",
                    "bsr_matmul", "bsr_quant_matmul"}
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, 8])
def test_cuda_graph_replay_matches_eager(cuda_device, page_size):
    """The smoke minicpm3 served with every decode dispatch a graph replay
    (the whole latent cache expanded at every micro-step), against the
    same engine stepping eagerly: greedy tokens equal."""
    out = []
    for eager in (False, True):
        model = ModelRegistry().load(MINICPM, device="cuda")
        eng = InferenceEngine(model, EngineConfig(
            n_slots=3, max_len=MAX_LEN, decode_chunk=2, page_size=page_size))
        if eager:
            eng.backend._graph = None
        out.append(_run(eng, _jobs(256)))
    assert out[0] == out[1]
