"""Port parity, training: the data pipeline, the training-time Kratos apply
(straight-through fake-quant, the systolic mask, the tree path's kept
blocks) and its gradient, one train step of every arch (loss, every
leaf's gradient, the parameters after 3 AdamW steps), QAT through a whole
model, gradient accumulation and the wrappers' autograd guard. Every case starts both packages from the JAX package's
`init_train_state(PRNGKey(0), ...)` carried across by
`checkpoint.convert.convert_state`, and holds the port against the JAX
package's own `backend="ref"` train step under jax.jit."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.checkpoint.manager import _flatten_with_paths
from repro.core import kratos as jkr
from repro.data import pipeline as JD
from repro.distributed import steps as JST
from repro.optim import adamw as JO
from repro_torch import configs as PC
from repro_torch import tree as tu
from repro_torch.checkpoint import convert as CV
from repro_torch.core import kratos as pkr
from repro_torch.core import sparsity as psp
from repro_torch.data import pipeline as PD
from repro_torch.distributed import steps as PST
from repro_torch.kernels import ops
from repro_torch.kernels.ledger_probe import N_FIXED
from repro_torch.optim import adamw as PO



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_spec(s):
    return pkr.KratosSpec(sparsity=s.sparsity, bits=s.bits, impl=s.impl,
                          bk=s.bk, bn=s.bn, act_bits=s.act_bits, seed=s.seed)


def flat(tree):
    """A JAX (or port reference-layout) tree as {key path: numpy}."""
    if isinstance(tree, dict) and any(isinstance(v, torch.Tensor)
                                      for v in tu.leaves(tree)):
        return {k: v.detach().numpy() for k, v in
                tu.flatten_with_paths(tree).items()}
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


def carried(jcfg, pcfg, jopt):
    """(JAX train state, the port's) on JAX's PRNGKey(0) init."""
    jst = JST.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    return jst, CV.convert_state(flat(jst), pcfg)


def data_cfg(cfg, batch=2, seq=16, **kw):
    return dict(vocab=cfg.vocab, batch=batch, seq=seq,
                frames=cfg.enc_positions if cfg.enc_dec else 0,
                d_model=cfg.d_model, img_tokens=cfg.n_img_tokens, **kw)


def batches(cfg, steps, **kw):
    pipe = PD.make_pipeline(PD.DataConfig(**data_cfg(cfg, **kw)))
    return [pipe.batch(s) for s in steps]


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def pbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_grads(pcfg, params, batch):
    """(total, loss, reference-layout grads) of the port's loss."""
    leaves = tu.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, loss = PST.make_loss_fn(pcfg)(params, pbatch(batch))
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return (total.detach(), loss.detach(),
            flat(CV.to_reference(tu.unflatten(params, grads), pcfg)))


def assert_grads_close(got, want, rtol=1e-4, atol_rel=1e-5):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=atol_rel * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=100, batch=4, seq=8, seed=1),
    dict(vocab=100, batch=4, seq=8, seed=2, source="uniform"),
    dict(vocab=64, batch=2, seq=6, frames=12, d_model=16),
    dict(vocab=64, batch=2, seq=6, img_tokens=5, d_model=16)],
    ids=["markov", "uniform", "frames", "img"])
def test_data_batches_bitwise_equal(kw):
    jp = JD.make_pipeline(JD.DataConfig(**kw))
    pp = PD.make_pipeline(PD.DataConfig(**kw))
    np.testing.assert_array_equal(pp._succ, jp._succ)
    for step in (0, 1, 7):
        jb, pb = jp.batch(step), pp.batch(step)
        assert set(pb) == set(jb)
        for k in jb:
            assert pb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


# ---------------------------------------------------------------------------
# the training-time Kratos apply
# ---------------------------------------------------------------------------

SPECS = [
    jkr.KratosSpec(),
    jkr.KratosSpec(sparsity=0.5, bk=8, bn=8),
    jkr.KratosSpec(sparsity=0.5, bk=8, bn=8, impl="systolic"),
    jkr.KratosSpec(bits=8),
    jkr.KratosSpec(bits=4),
    jkr.KratosSpec(sparsity=0.75, bits=8, bk=8, bn=8),
    jkr.KratosSpec(sparsity=0.5, bits=4, bk=8, bn=8),
    jkr.KratosSpec(bits=8, act_bits=8),
]


def _spec_id(s):
    return f"s{s.sparsity}b{s.bits}{s.impl[0]}a{s.act_bits}"


def _leaf(spec, seed=0):
    w = np.asarray(jkr.init(jax.random.PRNGKey(seed), 64, 32, spec)["w"])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (8, 64)))
    return w, x


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_training_apply_and_grad_match_jax(spec):
    """y = apply({"w"}, x) and dL/dw, L = sum(y * cot), equal jax.jit of
    the JAX package's apply and jax.grad; a pruned block's gradient is an
    exact zero (tree and systolic)."""
    w, x = _leaf(spec)
    cot = np.random.default_rng(3).standard_normal((8, 32)).astype(np.float32)

    def jloss(w):
        y = jkr.apply({"w": w}, jnp.asarray(x), spec)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(w))
    pw = torch.from_numpy(w).requires_grad_(True)
    with ops.reference_path():
        py = pkr.apply({"w": pw}, torch.from_numpy(x), port_spec(spec))
    (pg,) = torch.autograd.grad(torch.sum(py * torch.from_numpy(cot)), pw)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-5,
                               atol=1e-6 * np.abs(jg).max())
    plan = pkr.plan_for(64, 32, port_spec(spec))
    if plan is not None:
        pruned = psp.plan_mask(plan) == 0
        assert (pg.numpy()[pruned] == 0).all()


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_kratos_train_vs_packed(spec):
    """The port's pack() + apply_packed equals its training apply on the
    same dense weight, at the JAX test's tolerances."""
    w, x = _leaf(spec)
    pspec = port_spec(spec)
    with ops.reference_path():
        y_train = pkr.apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                            pspec)
    y_serve = pkr.apply_packed(pkr.pack_linear({"w": torch.from_numpy(w)},
                                               pspec), torch.from_numpy(x))
    rtol = 0.08 if spec.act_bits else 1e-4     # a8 requantizes activations
    np.testing.assert_allclose(y_serve.numpy(), y_train.numpy(), rtol=rtol,
                               atol=0.05)


def test_dense_leaf_needs_the_reference_path():
    """A dense leaf outside the reference path is refused: a model is
    served packed and trained through the train step."""
    with pytest.raises(RuntimeError, match="reference_path"):
        pkr.apply({"w": torch.zeros(4, 4)}, torch.zeros(1, 4))


# ---------------------------------------------------------------------------
# the wrappers' autograd guard
# ---------------------------------------------------------------------------

def _wrapper_calls(x):
    """One call of every hand-written wrapper, on CPU operands built
    around the float operand x (m = 2 rows of 16)."""
    from repro_torch.core import quantize as qz
    w = torch.randn(16, 8)
    qt = qz.quantize(w, 8)
    blocks = torch.randn(1, 2, 8, 8)
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    q3 = x.reshape(2, 1, 16)
    pages = torch.randn(3, 2, 4, 16)
    return {
        "dense_matmul": lambda: ops.matmul(x, w),
        "bsr_matmul": lambda: ops.bsr_matmul(x, blocks, idx),
        "bsr_matmul_experts": lambda: ops.bsr_matmul_experts(
            x[None], blocks[None], idx),
        "quant_matmul": lambda: ops.quant_matmul(x, qt),
        "quant_matmul_w8a8": lambda: ops.quant_matmul_w8a8(x, qt),
        "bsr_quant_matmul": lambda: ops.bsr_quant_matmul(
            x, torch.randint(-127, 128, (1, 2, 8, 8), dtype=torch.int8),
            torch.ones(1, 8), idx, 8),
        "flash_attention": lambda: ops.flash_attention(
            q3[None], q3[None], q3[None]),
        "paged_flash_attention": lambda: ops.paged_attention(
            q3.reshape(1, 2, 1, 16), pages, pages,
            torch.tensor([[1, 2]], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32)),
        "ssm_scan": lambda: ops.ssm_scan(
            x.reshape(1, 2, 16), x.reshape(1, 2, 16).abs(),
            torch.randn(1, 2, 4), torch.randn(1, 2, 4), -torch.rand(16, 4)),
        "ledger_probe": lambda: ops.ledger_probe(
            x, 8, torch.zeros(N_FIXED + 4 + 1), threshold=1e-3, group=4,
            k_block=8),
    }


def test_every_wrapper_refuses_to_cut_the_graph():
    """Under grad mode an operand that requires grad makes every wrapper
    raise (on the CPU too); on the reference path every wrapper raises
    whatever its operands; a plain operand, or torch.no_grad(), runs."""
    x = torch.randn(2, 16)
    calls = _wrapper_calls(x)
    assert set(calls) == set(ops.KERNELS)
    for name, call in calls.items():
        call()                                   # plain operands run
    xg = x.clone().requires_grad_(True)
    for name, call in _wrapper_calls(xg).items():
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    with ops.reference_path():
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match="reference path"):
                call()
    assert not ops.on_reference_path()


# ---------------------------------------------------------------------------
# one train step of every arch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_step_and_grads(arch, grad_accum=1):
    cfg = JC.get_smoke(arch)
    opt = JO.OptimizerConfig()
    step = JST.make_train_step(cfg, opt, grad_accum=grad_accum)
    vg = jax.value_and_grad(JST.make_loss_fn(cfg), has_aux=True)
    return jax.jit(lambda s, b: (step(s, b), vg(s["params"], b)))


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_train_step_matches_jax(arch):
    """Step 1's loss (rtol 1e-5), every leaf's gradient (rtol 1e-4, atol
    1e-5 x the leaf's max |g|), and the parameters and AdamW state after 3
    steps (atol 2e-5) under the default OptimizerConfig."""
    jcfg, pcfg = JC.get_smoke(arch), PC.get_smoke(arch)
    jst, pst = carried(jcfg, pcfg, JO.OptimizerConfig())
    both = _jax_step_and_grads(arch)
    step = PST.make_train_step(pcfg, PO.OptimizerConfig())
    bs = batches(jcfg, (0, 1, 2))
    total, loss, pg = port_grads(pcfg, pst["params"], bs[0])
    (_, jm), ((jtotal, jloss), jg) = both(jst, jbatch(bs[0]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert_grads_close(pg, flat(jg))
    for i, b in enumerate(bs):
        (jst, jm), _ = both(jst, jbatch(b))
        pst, pm = step(pst, pbatch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    got, want = flat(CV.state_to_reference(pst, pcfg)), flat(jst)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-5,
                                   err_msg=k)


def test_qat_through_the_whole_model():
    """s0.5 x int8 on 8 x 8 blocks through h2o-danube's smoke model (the
    JAX test_models case): the step's loss equals JAX's and every pruned
    block is exactly zero after the update."""
    spec = jkr.KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)
    jcfg = dataclasses.replace(JC.get_smoke("h2o_danube_1_8b"), kratos=spec)
    pcfg = dataclasses.replace(PC.get_smoke("h2o_danube_1_8b"),
                               kratos=port_spec(spec))
    opt = JO.OptimizerConfig()
    jst, pst = carried(jcfg, pcfg, opt)
    b = batches(jcfg, (0,))[0]
    jst, jm = jax.jit(JST.make_train_step(jcfg, opt))(jst, jbatch(b))
    pst, pm = PST.make_train_step(pcfg, PO.OptimizerConfig())(pst, pbatch(b))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    n = 0
    for lp in pst["params"]["layers"]:
        for node in (lp["mixer"], lp["ffn"]):
            for w in node.values():
                plan = pkr.plan_for(*w["w"].shape, pcfg.kratos)
                mask = torch.from_numpy(psp.plan_mask(plan))
                assert (w["w"][mask == 0] == 0).all()
                n += 1
    assert n == 7 * pcfg.n_layers


# ---------------------------------------------------------------------------
# remat: torch.utils.checkpoint around each layer changes no number
# ---------------------------------------------------------------------------

REMAT = {"nothing": dict(remat=True, remat_policy="nothing"),
         "dots": dict(remat=True, remat_policy="dots"),
         "policy-none": dict(remat=True, remat_policy="none"),
         "off": dict(remat=False)}


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "deepseek_moe_16b",
                                  "falcon_mamba_7b", "whisper_large_v3"],
                         ids=["dense", "moe", "mamba", "whisper"])
def test_remat_changes_no_number(arch, monkeypatch):
    """One smoke loss and its gradients with remat on ('nothing', 'dots'),
    under policy 'none' and with remat off: the loss and every leaf's
    gradient equal bitwise. Remat wraps every layer (whisper's encoder
    layers too) exactly when it is on, counted at
    torch.utils.checkpoint.checkpoint."""
    base = PC.get_smoke(arch)
    st = PST.init_train_state(0, base, PO.OptimizerConfig(), device="cpu")
    b = batches(base, (0,))[0]
    wrapped = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **kw):
        wrapped.append(fn)
        return real(fn, *a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    got = {}
    for tag, kw in REMAT.items():
        wrapped.clear()
        total, loss, g = port_grads(dataclasses.replace(base, **kw),
                                    st["params"], b)
        on = kw["remat"] and kw.get("remat_policy") != "none"
        assert len(wrapped) == (base.n_layers + base.n_enc_layers
                                if on else 0), (tag, len(wrapped))
        got[tag] = (total, loss, g)
    total, loss, g = got["off"]
    for tag, (t2, l2, g2) in got.items():
        assert torch.equal(t2, total) and torch.equal(l2, loss), tag
        assert set(g2) == set(g)
        for k in g:
            np.testing.assert_array_equal(g2[k], g[k], err_msg=f"{tag} {k}")


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

GA_OPT = dict(lr=0.0, weight_decay=0.0, clip_norm=None)


def _accum_step(jcfg, pcfg, b, ga):
    """(JAX metrics, port metrics) of one grad_accum=ga step on b."""
    jopt, popt = JO.OptimizerConfig(**GA_OPT), PO.OptimizerConfig(**GA_OPT)
    jst, pst = carried(jcfg, pcfg, jopt)
    _, jm = jax.jit(JST.make_train_step(jcfg, jopt, grad_accum=ga))(
        jst, jbatch(b))
    _, pm = PST.make_train_step(pcfg, popt, grad_accum=ga)(pst, pbatch(b))
    return jm, pm


def _rand_batch(vocab, shape):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": rng.integers(0, vocab, shape).astype(np.int32)}


def test_grad_accum_matches_one_batch_and_jax():
    """grad_accum 4 against 1 on one batch of 8 (lr 0, no decay or clip,
    the JAX test's case): equal to each other, and each equal to JAX's."""
    jcfg, pcfg = JC.get_smoke("h2o_danube_1_8b"), \
        PC.get_smoke("h2o_danube_1_8b")
    b = _rand_batch(jcfg.vocab, (8, 16))
    got = {}
    for ga in (1, 4):
        jm, pm = _accum_step(jcfg, pcfg, b, ga)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} ga={ga}")
        got[ga] = pm
    assert abs(float(got[1]["loss"]) - float(got[4]["loss"])) < 1e-4
    assert abs(float(got[1]["grad_norm"]) - float(got[4]["grad_norm"])) \
        / float(got[1]["grad_norm"]) < 1e-3


def test_grad_accum_split_is_interleaved_for_moe(monkeypatch):
    """deepseek-moe's smoke model on 16 one-token rows, grad_accum 4: each
    microbatch of 4 tokens routes as one group at capacity 2, so which
    rows share a microbatch decides the drops. The port's interleaved
    split equals JAX's step; a contiguous split (rows 4j .. 4j + 3) parts
    from it."""
    jcfg, pcfg = JC.get_smoke("deepseek_moe_16b"), \
        PC.get_smoke("deepseek_moe_16b")
    b = _rand_batch(jcfg.vocab, (16, 1))
    jm, pm = _accum_step(jcfg, pcfg, b, 4)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    monkeypatch.setattr(PST, "_microbatch", lambda x, j, ga: x.reshape(
        ga, x.shape[0] // ga, *x.shape[1:])[j])
    _, cm = _accum_step(jcfg, pcfg, b, 4)
    assert abs(float(cm["loss"]) - float(jm["loss"])) \
        / float(jm["loss"]) > 1e-4
