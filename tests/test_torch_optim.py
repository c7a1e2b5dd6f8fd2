"""Port parity, the optimizer and gradient compression: AdamW's schedule,
clipping, count and update against the JAX package's `adamw_update` on a
random tree, the quadratic convergence case, and `ef_int8_compress`'s codes
(bit for bit with jax.jit of the JAX package's) and residuals, then a
compressed training run that still learns (the JAX package's
fault-tolerance case, on the port alone)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.distributed import compression as JGC
from repro.optim import adamw as JO
from repro_torch import configs as PC
from repro_torch import tree as tu
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import compression as PGC
from repro_torch.optim import adamw as PO
from repro_torch.train import TrainLoopConfig, run_training


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (4, 2, 3)},
              "e": [(6,), (2, 2)]}
    return tu.tree_map(lambda s: (rng.standard_normal(s) * scale)
                       .astype(np.float32), shapes,
                       is_leaf=lambda x: isinstance(x, tuple))


def _to_jax(tree):
    return tu.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return tu.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=0.5),
    dict(lr=5e-3, warmup_steps=0, total_steps=4, clip_norm=None,
         weight_decay=0.0, min_lr_ratio=1.0)],
    ids=["default", "clipped", "no-clip"])
def test_adamw_matches_jax(kw):
    """Six updates of a random tree with fresh random gradients: params,
    m, v, count and the returned norm against jax.jit of the JAX
    package's adamw_update; the schedule at every count."""
    jcfg, pcfg = JO.OptimizerConfig(**kw), PO.OptimizerConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp, pp = _to_jax(p0), _to_torch(p0)
    js, ps = JO.adamw_init(jp, jcfg), PO.adamw_init(pp, pcfg)
    upd = jax.jit(lambda g, s, p: JO.adamw_update(g, s, p, jcfg))
    for _ in range(6):
        g = _tree(rng, scale=3.0)
        jp, js, jgn = upd(_to_jax(g), js, jp)
        pp, ps, pgn = PO.adamw_update(_to_torch(g), ps, pp, pcfg)
        assert int(ps["count"]) == int(js["count"])
        np.testing.assert_allclose(float(pgn), float(jgn), rtol=1e-6)
        for name, got, want in (("p", pp, jp), ("m", ps["m"], js["m"]),
                                ("v", ps["v"], js["v"])):
            for a, b in zip(tu.leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=name)
    for step in (0, 1, 2, 3, 5, 10, 11):
        np.testing.assert_allclose(
            float(PO.warmup_cosine(pcfg, step)),
            float(JO.warmup_cosine(jcfg, jnp.int32(step))), rtol=1e-6)


def test_adamw_schedule_and_clip():
    """The JAX package's schedule and clip case, on the port."""
    cfg = PO.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(PO.warmup_cosine(cfg, s)) for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] == pytest.approx(1e-4, rel=1e-2)
    g = {"w": torch.full((4,), 10.0)}
    clipped, gn = PO.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(
        1.0, rel=1e-4)
    with pytest.raises(NotImplementedError, match="not stacked"):
        PO.adamw_update(g, PO.adamw_init(g, cfg), g,
                        PO.OptimizerConfig(chunk_stacked_update=True))


def test_adamw_converges_on_quadratic():
    cfg = PO.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                             weight_decay=0.0, clip_norm=None,
                             min_lr_ratio=1.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = PO.adamw_init(params, cfg)
    target = torch.tensor([1.0, 2.0, 3.0])
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        params, state, _ = PO.adamw_update({"w": g}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_ef_int8_codes_bitwise_on_1000_leaves():
    """_quant_int8's codes and scale equal jax.jit of the JAX package's bit
    for bit on 1000 random leaves (10 sizes from 1 to 4999, magnitudes
    1e-6..1e2); ef_int8_compress's dequantized grads and residuals follow
    (rtol 1e-6), over two steps of error feedback."""
    rng = np.random.default_rng(0)
    quant = jax.jit(jax.vmap(JGC._quant_int8))      # one compile a size
    for n in rng.integers(1, 5000, 10):
        x = (rng.standard_normal((100, int(n)))
             * 10 ** rng.uniform(-6, 2, (100, 1))).astype(np.float32)
        jq, js = quant(jnp.asarray(x))
        for row, q, s in zip(x, np.asarray(jq), np.asarray(js)):
            pq, ps = PGC._quant_int8(torch.from_numpy(row))
            np.testing.assert_array_equal(pq.numpy(), q)
            assert ps.item() == float(s)
    grads = [_tree(rng, scale=s) for s in (1e-3, 2.0)]
    comp = jax.jit(JGC.ef_int8_compress)
    je = pe = None
    for g in grads:
        jd, je = comp(_to_jax(g), je)
        pd, pe = PGC.ef_int8_compress(_to_torch(g), pe)
        for a, b in zip(tu.leaves(pd) + tu.leaves(pe),
                        jax.tree_util.tree_leaves(jd)
                        + jax.tree_util.tree_leaves(je)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    init = PGC.ef_init(_to_torch(grads[0]))
    assert all(float(t.abs().sum()) == 0 for t in tu.leaves(init))


def test_grad_compression_run_converges():
    """int8 error-feedback compression: training still learns (the markov
    loss drops by 0.3 over 30 steps) and the residuals ride in the state."""
    cfg = PC.get_smoke("h2o_danube_1_8b")
    out = run_training(
        cfg, PO.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30),
        DataConfig(vocab=cfg.vocab, batch=2, seq=16, seed=5),
        TrainLoopConfig(steps=30, log_every=0),
        compress_fn=PGC.ef_int8_compress, device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] - 0.3
    assert "comp" in out["state"]
