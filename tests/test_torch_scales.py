"""Port parity, quantization scales against the jitted reference.

The JAX package serves under jax.jit: it fake-quantizes the routed experts
inside the forward (`kratos._ste_quant`) and quantizes w8a8 activations
inside the step. There XLA's CPU backend computes `amax / qmax + 1e-12` as
one FMA of amax and the f32 reciprocal of qmax, which differs from the
eager true division in a few channels; its sums (the 2- and 1-bit scales)
run in a tree of 32-row windows, eager or jitted. At 2048 x 1408 eager
and jitted 8-bit scales differ in 28 of 1408 channels (836 at 4 bits), and
at 512 x 2560 the activation row scales in a dozen rows: the shapes below
are chosen so that a port following eager JAX, or summing in its own
order, fails. Projection packing stays eager, as the JAX registry packs.
`cuda`-marked tests hold the card's w8a8 row scales and fake-quant to the
CPU's bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    import jax.numpy as jnp

    from repro.core import kratos as jkr
    from repro.core import quantize as jqz
    from repro.core import sparsity as jsp

from repro_torch.core import kratos as pkr
from repro_torch.core import quantize as pqz

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
W_SHAPE = (2048, 1408)          # deepseek-moe's w_gate: eager != jit
X_SHAPE = (512, 2560)           # h2o-danube's prefill rows at d_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


@needs_jax
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_fake_quantize_matches_jitted_reference(bits):
    """The port's fake_quantize (the expert fake-quant `pack_experts`
    freezes) equals jax.jit of the JAX function bit for bit at 2048 x 1408,
    where the eager 8- and 4-bit scales differ from the jitted ones and a
    sum in torch's own order moves the 2- and 1-bit scales."""
    w = rnd(0, W_SHAPE, W_SHAPE[0] ** -0.5)
    want = np.asarray(_jit(jqz.fake_quantize, 1)(jnp.asarray(w), bits))
    if bits in (8, 4):
        eager = np.asarray(jqz.fake_quantize(jnp.asarray(w), bits))
        assert (eager != want).any(), "the shape no longer tells eager from jit"
    got = pqz.fake_quantize(torch.from_numpy(w), bits).numpy()
    np.testing.assert_array_equal(got, want)
    scale = pqz.compute_scale(torch.from_numpy(w), bits, jitted=True).numpy()
    np.testing.assert_array_equal(scale, np.asarray(
        _jit(jqz.compute_scale, 1)(jnp.asarray(w), bits)))


@needs_jax
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_projection_packing_keeps_eager_division(bits):
    """`quantize` (projection packing) equals the JAX package's eager
    `quantize`, the registry's packing, at the same discriminating shape:
    scale and packed codes bit for bit."""
    w = rnd(1, W_SHAPE, W_SHAPE[0] ** -0.5)
    want = jqz.quantize(jnp.asarray(w), bits)
    got = pqz.quantize(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


@needs_jax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_quantization_matches_jitted_reference(dtype):
    """quantize_activations_int8 at 512 x 2560: row scales and codes equal
    jax.jit of the JAX function (the w8a8 step quantizes inside jit); in
    f32 the eager scales differ there."""
    x = rnd(2, X_SHAPE, 3.0)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    wq, ws = map(np.asarray, jax.jit(jqz.quantize_activations_int8)(jx))
    if dtype == "float32":
        _, es = jqz.quantize_activations_int8(jx)
        assert (np.asarray(es) != ws).any(), \
            "the shape no longer tells eager from jit"
    px = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, s = pqz.quantize_activations_int8(px)
    np.testing.assert_array_equal(s.numpy(), ws)
    np.testing.assert_array_equal(q.numpy(), wq)


@needs_jax
@pytest.mark.parametrize("bits", [8, 4])
def test_pack_experts_matches_jitted_ste_quant(bits):
    """`pack_experts` under s0.5 at 8 and 4 bits: each expert's kept blocks
    equal those of jax.jit(jax.vmap(_ste_quant)) over the stack, the
    weight the reference's jitted expert FFN gathers, at 2 x 2048 x 1408."""
    w = rnd(3, (2,) + W_SHAPE, W_SHAPE[0] ** -0.5)
    spec = dict(sparsity=0.5, bits=bits, bk=128, bn=128)
    packed = pkr.pack_experts(torch.from_numpy(w), pkr.KratosSpec(**spec))
    plan = jkr.plan_for(*W_SHAPE, jkr.KratosSpec(**spec))
    ste = jax.jit(jax.vmap(lambda we: jkr._ste_quant(we, bits)))(
        jnp.asarray(w))
    eager = jkr._ste_quant(jnp.asarray(w[0]), bits)
    assert (np.asarray(eager) != np.asarray(ste[0])).any()
    for e in range(2):
        np.testing.assert_array_equal(
            packed.blocks[e].numpy(),
            np.asarray(jsp.pack_blocks(ste[e], plan)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_w8a8_row_scales_match_cpu(cuda_device, dtype):
    """The card's row-quantize kernel (the w8a8 tile form) writes the row
    scales and codes the CPU computes, bit for bit: 512 x 2560, x_proj's
    rows of 8192, and a ragged width, with an all-zero row and an outlier."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import quant_matmul as qm
    dt = getattr(torch, dtype)
    for m, n, p in ((512, 2560, 640), (77, 8192, 288), (33, 255, 97)):
        assert gemm_plan.w8a8_plan(m, n, p).form == "tile"
        qt = pqz.quantize(torch.from_numpy(rnd(4, (n, p), n ** -0.5)).to(
            cuda_device), 8)
        x = torch.from_numpy(rnd(5, (m, n), 3.0))
        x[0] = 0.0
        x[m - 1, n // 3] = 1e4
        x = x.to(dt)
        _, xq, xs = qm._w8a8_launch(x.to(cuda_device), qt)
        wq, ws = pqz.quantize_activations_int8(x)
        assert torch.equal(xs.cpu(), ws[:, 0]), f"m={m} n={n}: row scales"
        assert torch.equal(xq[:, :n].cpu(), wq), f"m={m} n={n}: codes"


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_cuda_fake_quantize_matches_cpu(cuda_device, bits):
    """fake_quantize on the card (how `pack_experts` freezes a stack loaded
    there) equals the CPU's bit for bit at 2048 x 1408: the FMA in f64 and
    the windowed sum are plain elementwise ops."""
    w = torch.from_numpy(rnd(6, W_SHAPE, W_SHAPE[0] ** -0.5))
    got = pqz.fake_quantize(w.to(cuda_device), bits).cpu()
    assert torch.equal(got, pqz.fake_quantize(w, bits))
