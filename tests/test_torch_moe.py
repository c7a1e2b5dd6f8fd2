"""Port parity, mixture-of-experts (deepseek-moe-16b; deepseek-v2-lite,
MLA + MoE).

On the CPU, with numpy inputs from a seed and JAX weights carried across:
  * `moe_apply` against JAX's under DENSE, s0.5, s0.5-w8, w8 (raw float
    experts) and systolic s0.5, one group per row (S > 1) and one global
    group (S == 1), at capacity factor 1.0 so that assignments drop; with
    no drop against `moe_ref` (the port's and JAX's dense oracle);
  * the routed stacks' pack-time form: fake-quant float blocks over the
    shared plan (the blocks JAX's training-time apply gathers) under a
    block-sparse tree spec, the raw float stack otherwise;
  * the plain `bsr_matmul_experts` against a vmap of JAX's `bsr_matmul`
    in Pallas interpret mode;
  * `layer_kind` / `param_count` and the smoke forward (prefill, then
    decode with per-slot clocks) against JAX `T.forward`;
  * greedy engine tokens equal JAX's engine: the slab with fewer requests
    than slots (parked rows route too), and the page pool with prefix and
    conversation reuse, at the smoke capacity and at 1.0;
  * prompts prefill at exact length, and speculative decode is refused.
`cuda`-marked tests hold the expert-batched kernel to its plain version at
deepseek's shapes (with a bitwise second call), an MoE layer on the card
to its CPU plain path, and a graphed engine to the eager step."""

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
    from repro.core import sparsity as jsp
    from repro.kernels import ops as jops
    from repro.models import moe as JM
    from repro.models import transformer as JT
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.kernels import gemm_plan
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                               ModelRegistry)
from repro_torch.serve.registry import pack_model_params, tree_to

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
MOE, LITE = "deepseek-moe-16b", "deepseek-v2-lite-16b"
SPECS = {"dense": {}, "s0.5": dict(sparsity=0.5, bk=8, bn=8),
         "s0.5w8": dict(sparsity=0.5, bits=8, bk=8, bn=8),
         "w8": dict(bits=8),
         "systolic": dict(sparsity=0.5, bk=8, bn=8, impl="systolic")}
JOBS = ((5, 7), (11, 6), (9, 9))
N_SLOTS, MAX_LEN = 4, 32
MOE_KW = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32, n_shared=2)


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


# ---------------------------------------------------------------------------
# moe_apply and the expert stacks
# ---------------------------------------------------------------------------

def _moe_params(spec_name, capacity_factor=1.0):
    """(JAX MoEConfig, JAX params, port MoEConfig, port packed params)."""
    jcfg = JM.MoEConfig(capacity_factor=capacity_factor, **MOE_KW)
    pcfg = PM.MoEConfig(capacity_factor=capacity_factor, **MOE_KW)
    jspec = jkr.KratosSpec(**SPECS[spec_name])
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg, jspec)
    dense = jax.tree_util.tree_map(_t, jp)
    pp = pack_model_params({"ffn": dense},
                           pkr.KratosSpec(**SPECS[spec_name]))[0]["ffn"]
    return jcfg, jp, pcfg, pp


def _dropped(cfg, router_w, x):
    """Assignments that found their expert full, over all groups."""
    b, s, _ = x.shape
    g, t = (b, s) if s > 1 else (1, b * s)
    c = PM.capacity(cfg, t)
    gates = torch.softmax(x.reshape(g, t, -1) @ router_w, -1)
    top_e = torch.topk(gates, cfg.top_k, dim=-1).indices.reshape(g, -1)
    counts = torch.stack([torch.bincount(r, minlength=cfg.n_experts)
                          for r in top_e])
    return int((counts - c).clamp(min=0).sum())


@needs_jax
@pytest.mark.parametrize("shape", [(3, 10, 64), (6, 1, 64)],
                         ids=["group_per_row", "one_group"])
@pytest.mark.parametrize("name", list(SPECS))
def test_moe_apply_matches_jax_with_drops(name, shape):
    jcfg, jp, pcfg, pp = _moe_params(name)
    x = rnd(1, shape)
    assert _dropped(pcfg, pp["router"]["w"], _t(x)) > 0   # 1.0 drops some
    jy, _ = JM.moe_apply(jp, jnp.asarray(x), jcfg, spec=jkr.KratosSpec(
        **SPECS[name]))
    py = PM.moe_apply(pp, _t(x), pcfg)
    _close(py, jy, name)
    kind = pkr.PackedExperts if name in ("s0.5", "s0.5w8") else torch.Tensor
    assert all(isinstance(pp[n], kind) for n in PM.EXPERT_STACKS), name


@needs_jax
@pytest.mark.parametrize("shape", [(3, 10, 64), (6, 1, 64)],
                         ids=["group_per_row", "one_group"])
def test_moe_apply_without_drops_matches_moe_ref(shape):
    """A capacity that holds every assignment: the grouped dispatch equals
    the dense per-token oracle, the port's and JAX's."""
    jcfg, jp, pcfg, pp = _moe_params("dense", capacity_factor=64.0)
    x = rnd(2, shape)
    want = JM.moe_ref(jp, jnp.asarray(x), jcfg)
    _close(PM.moe_ref(pp, _t(x), pcfg), want, "port moe_ref")
    _close(PM.moe_apply(pp, _t(x), pcfg), want, "moe_apply")


@needs_jax
@pytest.mark.parametrize("name", list(SPECS) + ["w8a8"])
def test_expert_stacks_pack_as_the_reference_runs_them(name):
    """Tree specs with a plan: each expert's kept blocks of w + (fq(w) - w)
    (the reference's straight-through weight) over the one shared plan;
    every other spec keeps the raw float stack, unquantized."""
    spec = dict(bits=8, act_bits=8) if name == "w8a8" else SPECS[name]
    w = rnd(3, (8, 64, 32))
    layer = {"w_gate": _t(w), "w_up": _t(w),
             "w_down": _t(np.ascontiguousarray(w.transpose(0, 2, 1)))}
    packed = PM.pack_moe(layer, pkr.KratosSpec(**spec))["w_gate"]
    if name not in ("s0.5", "s0.5w8"):
        assert isinstance(packed, torch.Tensor) and np.array_equal(
            packed.numpy(), w)
        return
    jspec = jkr.KratosSpec(**spec)
    plan = jkr.plan_for(64, 32, jspec)
    assert packed.indices.dtype == torch.int32
    assert np.array_equal(packed.indices.numpy(), plan.indices)
    for e in range(8):
        we = jnp.asarray(w[e])
        if jspec.bits:
            we = jkr._ste_quant(we, jspec.bits)
        np.testing.assert_array_equal(packed.blocks[e].numpy(),
                                      np.asarray(jsp.pack_blocks(we, plan)))


@needs_jax
@pytest.mark.parametrize("m", [1, 6, 20])
def test_bsr_matmul_experts_plain_matches_vmapped_pallas(m):
    e, n, p, bk, bn = 4, 64, 48, 16, 16
    plan = jkr.plan_for(n, p, jkr.KratosSpec(sparsity=0.5, bk=bk, bn=bn))
    w = rnd(4, (e, n, p), n ** -0.5)
    x = rnd(5, (e, m, n))
    blocks = np.stack([np.asarray(jsp.pack_blocks(jnp.asarray(w[i]), plan))
                       for i in range(e)])
    idx = jnp.asarray(plan.indices)
    want = jax.vmap(lambda xx, bb: jops.bsr_matmul(
        xx, bb, idx, backend="interpret"))(jnp.asarray(x), jnp.asarray(blocks))
    got = pops.bsr_matmul_experts(_t(x), _t(blocks),
                                  torch.as_tensor(plan.indices))
    _close(got, want)
    for i in range(e):
        torch.testing.assert_close(
            got[i], pref.bsr_matmul_ref(_t(x[i]), _t(blocks[i]),
                                        torch.as_tensor(plan.indices)))


def test_expert_batched_plan_counts_every_expert():
    """With the experts in the launch, deepseek's projections need no
    k-split to fill the card, at decode (C = 6) and in a 512-token prefill
    (C = 60); one expert alone splits k. The prefill's 60 rows an expert
    take one 64-row tile, one expert alone a 128-row one."""
    for n_pb, nnz in ((11, 8), (16, 6)):          # 2048 -> 1408, 1408 -> 2048
        for c, form in ((6, "gemv"), (60, "tile")):
            one = gemm_plan.bsr_plan(c, n_pb, nnz, 128, 128, 0)
            pl = gemm_plan.bsr_plan(c, n_pb, nnz, 128, 128, 0, batch=64)
            assert (one.form, pl.form) == (form, form)
            assert pl.split == 1 < one.split
            assert pl.grid[1] * pl.split * 64 >= gemm_plan.SMS
            if form == "tile":
                assert (one.bm, pl.bm) == (128, 64)
                assert pl.smem_bytes == gemm_plan.tile_smem_bytes(
                    64, pl.bn, 1, 0, 4)
    # past 64 rows an expert the batched plan keeps the 128-row tiles
    assert gemm_plan.bsr_plan(65, 11, 8, 128, 128, 0, batch=64).bm == 128
    assert gemm_plan.bsr_plan(6, 11, 8, 128, 128, 0, batch=1) == \
        gemm_plan.bsr_plan(6, 11, 8, 128, 128, 0)


def test_capacity_matches_the_reference_formula():
    cfg = PM.MoEConfig(d_model=2048, n_experts=64, top_k=6,
                       d_ff_expert=1408, capacity_factor=1.25)
    assert PM.capacity(cfg, 8) == 6 and PM.capacity(cfg, 512) == 60
    assert PM.capacity(cfg, 1) == 6 and PM.capacity(cfg, 2048) == 240


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _carried(arch, name="dense"):
    cfg = JC.get_smoke(arch, kratos=jkr.KratosSpec(**SPECS[name]))
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported


def _port_model(arch, name="dense", capacity_factor=None):
    model = ModelRegistry().load(arch, pkr.KratosSpec(**SPECS[name]),
                                 params=_carried(arch, name)[2],
                                 device="cpu")
    if capacity_factor is not None:
        model.cfg = dataclasses.replace(model.cfg,
                                        capacity_factor=capacity_factor)
    return model


@needs_jax
@pytest.mark.parametrize("arch", [MOE, LITE])
def test_layer_kind_param_count_and_forward_match_jax(arch):
    for get in ("get_config", "get_smoke"):
        jcfg, pcfg = getattr(JC, get)(arch), getattr(PC, get)(arch)
        assert [PT.layer_kind(pcfg, i) for i in range(pcfg.n_layers)] == \
            [JT.layer_kind(jcfg, i) for i in range(jcfg.n_layers)]
        assert pcfg.param_count() == jcfg.param_count()
        assert PT.layer_order(pcfg) == list(range(pcfg.n_layers))
    assert PC.get_config(MOE).param_count() == 16_375_611_392
    for name in ("dense", "s0.5w8"):
        cfg, params, _ = _carried(arch, name)
        model = _port_model(arch, name)
        b, s0, max_len = 3, 10, 24
        tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
            .astype(np.int32)
        jc = JT.make_caches(cfg, b, max_len, jnp.float32)
        jlog, _, jc = JT.forward(params, jnp.asarray(tokens), cfg, caches=jc)
        pc = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
        plog, pc = PT.forward(model.params, _t(tokens), model.cfg, caches=pc)
        _close(plog, jlog, f"{name} prefill")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
        for step in range(4):
            index = np.array([s0 + step, s0 + step - 2, s0 + step - 5],
                             np.int32)
            jlog, _, jc = JT.forward(params, jnp.asarray(tok[:, None]), cfg,
                                     caches=jc, index=jnp.asarray(index))
            plog, pc = PT.forward(model.params, _t(tok[:, None]), model.cfg,
                                  caches=pc, index=_t(index))
            _close(plog, jlog, f"{name} decode {step}")
            tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, name, capacity_factor=None, **kw):
    cfg, params, _ = _carried(arch, name)
    model = JRegistry().load(arch, jkr.KratosSpec(**SPECS[name]),
                             params=params)
    if capacity_factor is not None:
        model.cfg = dataclasses.replace(model.cfg,
                                        capacity_factor=capacity_factor)
    eng = JEngine(model, JEngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                       **kw))
    return _run(eng, _jobs(cfg.vocab))


@needs_jax
@pytest.mark.parametrize("arch,name,capacity_factor", [
    (MOE, "dense", None), (MOE, "s0.5", None), (MOE, "s0.5w8", None),
    (MOE, "w8", None), (MOE, "dense", 1.0), (MOE, "s0.5w8", 1.0),
    (LITE, "dense", None), (LITE, "s0.5w8", 1.0)])
def test_slab_engine_matches_jax(arch, name, capacity_factor):
    """Three requests on four slots, K 2: the parked row routes in every
    decode group (and at capacity 1.0 takes a share of the capacity)."""
    eng = InferenceEngine(
        _port_model(arch, name, capacity_factor),
        EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2,
                     device="cpu"))
    assert eng._exact_prefill and eng._prefill_len(5) == 5
    assert _run(eng, _jobs(256)) == _jax_tokens(
        arch, name, capacity_factor, decode_chunk=2)


def _serve_prefix(eng, vocab):
    """Four requests under a shared 16-token system prompt, then the
    second turn of the first conversation."""
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
@pytest.mark.parametrize("arch,capacity_factor", [
    (MOE, None), (MOE, 1.0), (LITE, None)])
def test_paged_prefix_reuse_matches_jax(arch, capacity_factor):
    """Prefix reuse stays on for MoE (its cache is positional); a matched
    admission routes only its suffix, so it is held to JAX's paged engine,
    token for token and counter for counter."""
    cfg, params, _ = _carried(arch)
    jmodel = JRegistry().load(arch, params=params)
    if capacity_factor is not None:
        jmodel.cfg = dataclasses.replace(jmodel.cfg,
                                         capacity_factor=capacity_factor)
    jeng = JEngine(jmodel, JEngineConfig(n_slots=2, max_len=48, page_size=8,
                                         decode_chunk=2))
    want_tok, want_matched, want_rep = _serve_prefix(jeng, cfg.vocab)
    eng = InferenceEngine(_port_model(arch, capacity_factor=capacity_factor),
                          EngineConfig(n_slots=2, max_len=48, page_size=8,
                                       decode_chunk=2, device="cpu"))
    assert eng.pool.index is not None
    tok, matched, rep = _serve_prefix(eng, cfg.vocab)
    assert tok == want_tok
    assert matched == want_matched == [0, 16, 16, 16, 24]
    assert {key: rep[key] for key in REUSE_KEYS} == \
        {key: want_rep[key] for key in REUSE_KEYS}


def test_speculation_refused_for_moe():
    with pytest.raises(NotImplementedError, match="item 8"):
        ModelRegistry().load(MOE, device="cpu",
                             draft_spec=DraftSpec(bits=8))
    model = ModelRegistry().load(MOE, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        InferenceEngine(model, EngineConfig(n_slots=2, max_len=16,
                                            speculate=2, device="cpu"))


@pytest.mark.parametrize("name", list(SPECS))
def test_registry_serves_every_spec(name):
    """Every spec loads and serves the smoke model on the CPU; routed
    stacks are never counted as packed projections."""
    model = ModelRegistry().load(MOE, pkr.KratosSpec(**SPECS[name]),
                                 device="cpu")
    ffn = model.params["layers"][1]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert set(ffn["router"]) == {"w"}
    n_linear = 4 * 3 + 3 + 2 * 3      # attention, prelude MLP, shared MLPs
    assert model.n_packed == n_linear
    eng = InferenceEngine(model, EngineConfig(n_slots=2, max_len=24,
                                              device="cpu"))
    out = _run(eng, _jobs(256)[:2])
    assert [len(t) for t in out] == [7, 6]


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


@pytest.mark.cuda
def test_cuda_bsr_matmul_experts_matches_plain_version(cuda_device):
    """deepseek's routed projections under s0.5 (64 experts, 2048 -> 1408
    and 1408 -> 2048) at decode (C = 6, the GEMV form) and in a 512-token
    prefill (C = 60, the tile form), f32 at 1e-4, one launch a call, and a
    second call bit for bit; plus a small mainloop-form shape (bn 8)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    spec = pkr.KratosSpec(sparsity=0.5)
    cases = [(64, 2048, 1408, 6, spec), (64, 1408, 2048, 6, spec),
             (64, 2048, 1408, 60, spec), (64, 1408, 2048, 60, spec),
             (8, 64, 32, 20, pkr.KratosSpec(sparsity=0.5, bk=8, bn=8))]
    forms = set()
    for e, n, p, c, sp_ in cases:
        w = torch.randn((e, n, p), generator=gen, device=cuda_device) \
            * n ** -0.5
        packed = pkr.pack_experts(w, sp_)
        x = torch.randn((e, c, n), generator=gen, device=cuda_device)
        pops.reset_launch_counts()
        got = pops.bsr_matmul_experts(x, packed.blocks, packed.indices)
        assert pops.launch_counts()["bsr_matmul_experts"] == 1
        want = pref.bsr_matmul_experts_ref(x, packed.blocks, packed.indices)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        again = pops.bsr_matmul_experts(x, packed.blocks, packed.indices)
        assert torch.equal(got, again), (n, p, c)
        n_pb, nnz, bk, bn = packed.blocks.shape[1:]
        forms.add(gemm_plan.bsr_plan(c, n_pb, nnz, bk, bn, 0,
                                     batch=e).form)
    assert forms == {"gemv", "tile", "mainloop"}
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense", "s0.5w8"])
def test_cuda_moe_layer_matches_cpu(cuda_device, name):
    """One deepseek MoE layer at published width (64 experts, top 6, 2
    shared), packed on the card, against the same raw weights packed on
    the CPU and run through the kernels' plain versions, decode (8 rows)
    and a 40-token sequence; s0.5-w8 runs the expert-batched kernel."""
    cfg = PM.MoEConfig(d_model=2048, n_experts=64, top_k=6,
                       d_ff_expert=1408, n_shared=2)
    spec = pkr.KratosSpec(**{k: v for k, v in SPECS[name].items()
                             if k not in ("bk", "bn")})
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    raw = PM.moe_init(cfg, spec, generator=gen, device=cuda_device,
                      dtype=torch.float32)
    on_cpu = pack_model_params({"ffn": tree_to(raw, "cpu")}, spec)[0]["ffn"]
    on_card = pack_model_params({"ffn": raw}, spec)[0]["ffn"]
    del raw
    for shape in ((8, 1, 2048), (1, 40, 2048)):
        x = torch.randn(shape, generator=gen, device=cuda_device)
        pops.reset_launch_counts()
        got = PM.moe_apply(on_card, x, cfg)
        n = pops.launch_counts()["bsr_matmul_experts"]
        assert n == (3 if name == "s0.5w8" else 0), n
        want = PM.moe_apply(on_cpu, x.cpu(), cfg)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_packing_matches_cpu_bit_for_bit(cuda_device, bits):
    """Packing on the card gives the CPU's buffers bit for bit, and so the
    JAX package's (the CPU tests hold the port's to them): deepseek's
    routed w_gate stack (64 x 2048 x 1408) under s0.5 with `bits`, its
    fake-quant float blocks, and one expert's weight packed to block-sparse
    codes and scales."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    spec = pkr.KratosSpec(sparsity=0.5, bits=bits)
    w = torch.randn((64, 2048, 1408), generator=gen, device=cuda_device) \
        * 2048 ** -0.5
    w_cpu = w.cpu()
    card, cpu = pkr.pack_experts(w, spec), pkr.pack_experts(w_cpu, spec)
    assert torch.equal(card.indices.cpu(), cpu.indices)
    assert torch.equal(card.blocks.cpu(), cpu.blocks)
    card, cpu = pkr.pack({"w": w[0]}, spec), pkr.pack({"w": w_cpu[0]}, spec)
    assert set(card) == set(cpu) == {"qblocks", "qscale"}
    for name in card:
        assert torch.equal(card[name].cpu(), cpu[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, 8])
def test_cuda_graph_replay_matches_eager(cuda_device, page_size):
    """The smoke deepseek-moe under s0.5 (bk = bn = 16: the expert-batched
    kernel at decode) served with every decode dispatch a graph replay,
    against the same engine stepping eagerly: greedy tokens equal, and a
    replay counts the batched kernel once per MoE projection."""
    spec = pkr.KratosSpec(sparsity=0.5, bk=16, bn=16)
    out = []
    for eager in (False, True):
        model = ModelRegistry().load(MOE, spec, device="cuda")
        eng = InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=2,
            page_size=page_size))
        if eager:
            eng.backend._graph = None
        else:
            assert eng.backend._graph_launches["bsr_matmul_experts"] == \
                2 * 2 * 3                # 2 micro-steps x 2 MoE layers x 3
        out.append(_run(eng, _jobs(256)))
    assert out[0] == out[1]
