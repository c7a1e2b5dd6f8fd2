"""Port parity, convolutions: `repro_torch.core.conv` against
`repro.core.conv` on the same numpy inputs. The JAX params are carried as
numpy (`conv.conv_params`: the `{"w"}` leaf and the int fw / fh).

Tolerances: im2col bitwise; the dense and reference-path convolutions,
the packed form on the CPU's plain versions and the F.conv oracle 1e-5
against JAX (both sum f32 products; the orders differ). On the card the
packed conv runs the hand-written kernels, held to the plain version at
1e-4 and to F.conv of the masked, fake-quantized filter at 2e-2 (the JAX
test's bound for the quantized conv)."""

import numpy as np
import pytest

from torch_serve_parity import jax, needs_jax, torch
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

if jax is not None:
    import jax.numpy as jnp

    from repro.core import conv as JC
    from repro.core import kratos as jkr

from repro_torch.core import conv as PC
from repro_torch.core import kratos as pkr
from repro_torch.core import quantize as pqz
from repro_torch.core import sparsity as psp
from repro_torch.kernels import ops

TOL = 1e-5
SPECS = {"dense": dict(), "s0.5": dict(sparsity=0.5, bk=4, bn=4),
         "s0.5-w8": dict(sparsity=0.5, bits=8, bk=4, bn=4)}
# (fw, ic, oc) and (fw, fh, ic, oc): k extents 12 and 36 divide bk = 4
CONV1D, CONV2D = (3, 4, 8), (3, 3, 4, 8)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jparams(kind, spec):
    key = jax.random.PRNGKey(3)
    if kind == "conv1d":
        return JC.conv1d_init(key, *CONV1D, spec)
    return JC.conv2d_init(key, *CONV2D, spec)


def _xshape(kind):
    return (2, 12, CONV1D[1]) if kind == "conv1d" else (2, 8, 7, CONV2D[2])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@needs_jax
@pytest.mark.parametrize("fw", [1, 3])
def test_im2col_1d_bitwise(fw):
    x = _x(0, (2, 9, 5))
    np.testing.assert_array_equal(
        PC.im2col_1d(torch.from_numpy(x), fw).numpy(),
        np.asarray(JC.im2col_1d(jnp.asarray(x), fw)))


@needs_jax
@pytest.mark.parametrize("fw,fh", [(3, 3), (2, 3), (1, 1)])
def test_im2col_2d_bitwise(fw, fh):
    x = _x(1, (2, 7, 6, 3))
    np.testing.assert_array_equal(
        PC.im2col_2d(torch.from_numpy(x), fw, fh).numpy(),
        np.asarray(JC.im2col_2d(jnp.asarray(x), fw, fh)))


@needs_jax
def test_conv_weight_as_gemm_order():
    w = _x(2, (3, 2, 4, 5))
    np.testing.assert_array_equal(
        PC.conv_weight_as_gemm(torch.from_numpy(w)).numpy(),
        np.asarray(JC.conv_weight_as_gemm(jnp.asarray(w))))


@needs_jax
@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
@pytest.mark.parametrize("tag", list(SPECS))
def test_conv_matches_jax_on_the_reference_path(kind, tag):
    """The training-time apply (dense leaf) on the reference path against
    JAX's `backend="ref"`, weights carried as numpy."""
    jspec, pspec = jkr.KratosSpec(**SPECS[tag]), pkr.KratosSpec(**SPECS[tag])
    jp = _jparams(kind, jspec)
    x = _x(4, _xshape(kind))
    want = getattr(JC, kind)(jp, jnp.asarray(x), jspec, backend="ref")
    pp = PC.conv_params(jp)
    assert set(pp) == set(jp) and all(isinstance(pp[k], int)
                                      for k in pp if k != "w")
    with ops.reference_path():
        got = getattr(PC, kind)(pp, torch.from_numpy(x), pspec)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_dense_leaf_refused_off_the_reference_path(kind):
    """A dense leaf is the training-time apply: off the reference path it
    raises, as the port's kratos.apply does."""
    gen = torch.Generator().manual_seed(0)
    p = (PC.conv1d_init(*CONV1D, generator=gen, device="cpu")
         if kind == "conv1d" else
         PC.conv2d_init(*CONV2D, generator=gen, device="cpu"))
    x = torch.randn(_xshape(kind), generator=gen)
    with pytest.raises(RuntimeError, match="reference"):
        getattr(PC, kind)(p, x)
    with pytest.raises(ValueError, match="fw"):
        PC.conv1d({"w": p["w"]}, x)


@needs_jax
@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
@pytest.mark.parametrize("tag", list(SPECS))
def test_packed_conv_matches_jax_apply_packed(kind, tag):
    """The packed form (pack_linear, a PackedLinear in params['w']) on the
    CPU's plain versions against JAX's apply_packed (`backend="ref"`) on
    the same patches."""
    jspec, pspec = jkr.KratosSpec(**SPECS[tag]), pkr.KratosSpec(**SPECS[tag])
    jp = _jparams(kind, jspec)
    x = _x(5, _xshape(kind))
    n, p = jp["w"].shape
    jlin = jkr.pack_linear({"w": jp["w"]}, jspec)
    patches = (JC.im2col_1d(jnp.asarray(x), jp["fw"]) if kind == "conv1d"
               else JC.im2col_2d(jnp.asarray(x), jp["fw"], jp["fh"]))
    want = jkr.apply_packed(jlin.buffers, patches, jlin.spec, n, p,
                            backend="ref")
    pp = PC.conv_params(jp)
    pp["w"] = pkr.pack_linear({"w": pp["w"]}, pspec)
    assert sorted(pp["w"].buffers) == sorted(jlin.buffers)
    got = getattr(PC, kind)(pp, torch.from_numpy(x), pspec)
    _close(got, want)


@needs_jax
@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_conv_ref_matches_lax_conv(kind):
    x = _x(6, _xshape(kind))
    if kind == "conv1d":
        w = _x(7, CONV1D)
    else:
        w = _x(7, CONV2D)
    want = getattr(JC, kind + "_ref")(jnp.asarray(x), jnp.asarray(w))
    got = getattr(PC, kind + "_ref")(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("tag", list(SPECS))
def test_conv2d_is_a_convolution_of_the_kratos_filter(tag):
    """conv2d through im2col equals F.conv2d of the masked, fake-quantized
    filter it multiplies (the JAX test's quantized-conv check, port only)."""
    spec = pkr.KratosSpec(**SPECS[tag])
    gen = torch.Generator().manual_seed(1)
    fw, fh, ic, oc = CONV2D
    p = PC.conv2d_init(fw, fh, ic, oc, spec, generator=gen, device="cpu")
    x = torch.randn((1, 8, 8, ic), generator=gen)
    with ops.reference_path():
        got = PC.conv2d(p, x, spec)
    w = p["w"]
    plan = pkr.plan_for(fw * fh * ic, oc, spec)
    if plan is not None:
        w = w * torch.as_tensor(psp.plan_mask(plan))
    if spec.bits is not None:
        w = pqz.fake_quantize(w, spec.bits)
    want = PC.conv2d_ref(x, w.reshape(fw, fh, ic, oc))
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", list(SPECS))
def test_cuda_packed_conv_matches_plain_and_f_conv(tag):
    """On the card the packed conv2d runs its kernel: held to the plain
    version of the same buffers at 1e-4 and to F.conv2d of the masked,
    fake-quantized filter at 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    spec = pkr.KratosSpec(**SPECS[tag])
    gen = torch.Generator(device="cuda").manual_seed(1)
    fw, fh, ic, oc = CONV2D
    p = PC.conv2d_init(fw, fh, ic, oc, spec, generator=gen, device="cuda")
    x = torch.randn((1, 8, 8, ic), generator=gen, device="cuda")
    lin = pkr.pack_linear({"w": p["w"]}, spec)
    ops.reset_launch_counts()
    got = PC.conv2d(dict(p, w=lin), x)
    assert sum(ops.launch_counts().values()) == 1
    patches = PC.im2col_2d(x, fw, fh)
    want = pkr.plain_packed(lin, patches)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    w = p["w"]
    plan = pkr.plan_for(fw * fh * ic, oc, spec)
    if plan is not None:
        w = w * torch.as_tensor(psp.plan_mask(plan), device="cuda")
    if spec.bits is not None:
        w = pqz.fake_quantize(w, spec.bits)
    torch.testing.assert_close(got, PC.conv2d_ref(x, w.reshape(fw, fh, ic, oc)),
                               rtol=2e-2, atol=2e-2)
