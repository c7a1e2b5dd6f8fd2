"""Port parity, quantized GEMMs: `quantize_activations_int8` codes and the
'qt' codes of `pack()` byte-identical to `repro.core`'s; the plain
versions of `quant_matmul` (w8/w4/w2/w1) and `quant_matmul_w8a8` (what the
wrappers run on a CPU tensor) against the JAX Pallas kernels in interpret
mode; the 'qt' branches of `apply_packed`. The CUDA kernels themselves are
held to the plain versions on the card (`cuda` marker; `chip_smoke.py`
runs the full-width grid)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from repro.core import kratos as jkr
    from repro.core import quantize as jqz
    from repro.kernels import ops as jops
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jnp = None

from repro_torch.core import kratos as pkr
from repro_torch.core import quantize as pqz
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

# (atol, rtol): f32 at the GEMM tolerance of tests/test_kernels.py; bf16
# outputs also within one bf16 ulp (both sides round an f32 product once,
# summed in a different order)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -7)}


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


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of `dtype`."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(a).astype(getattr(jnp, dtype)), t


def port_qt(jq) -> pqz.QuantizedTensor:
    return pqz.QuantizedTensor(data=torch.from_numpy(np.array(jq.data)),
                               scale=torch.from_numpy(np.array(jq.scale)),
                               bits=jq.bits, shape=tuple(jq.shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_codes_byte_identical(dtype):
    x = rnd(0, (37, 96), 3.0)
    x[5] = 0.0                                   # an all-zero row
    jx, px = both(x, dtype)
    jq, js = jqz.quantize_activations_int8(jx)
    pq, ps = pqz.quantize_activations_int8(px)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert tuple(ps.shape) == (37, 1)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("impl,sparsity", [("tree", 0.0),
                                           ("systolic", 0.5)])
def test_pack_qt_buffers_byte_identical(bits, impl, sparsity):
    w = rnd(bits, (64, 48), 0.5)
    spec = dict(sparsity=sparsity, bits=bits, impl=impl, bk=16, bn=16)
    jb = jkr.pack({"w": jnp.asarray(w)}, jkr.KratosSpec(**spec))
    pb = pkr.pack({"w": torch.from_numpy(w)}, pkr.KratosSpec(**spec))
    assert set(pb) == set(jb) == {"qt"}
    np.testing.assert_array_equal(pb["qt"].data.numpy(),
                                  np.asarray(jb["qt"].data))
    # scales are per-column f32 reductions summed in another order
    np.testing.assert_allclose(pb["qt"].scale.numpy(),
                               np.asarray(jb["qt"].scale), rtol=1e-6)
    assert pb["qt"].shape == tuple(jb["qt"].shape) and pb["qt"].bits == bits
    pl = pkr.pack_linear({"w": torch.from_numpy(w)}, pkr.KratosSpec(**spec))
    assert pl.packed_bytes == 64 * 48 // pqz.VALUES_PER_BYTE[bits] + 4 * 48


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m", [16, 3])
def test_quant_matmul_plain_vs_pallas(bits, dtype, m):
    jq = jqz.quantize(jnp.asarray(rnd(20 + bits, (64, 48), 0.5)), bits)
    jx, px = both(rnd(21, (m, 64)), dtype)
    want = jops.quant_matmul(jx, jq, backend="interpret", bk=32, bn=16)
    got = pops.quant_matmul(px, port_qt(jq))
    assert got.dtype == px.dtype and tuple(got.shape) == (m, 48)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [16, 5])
def test_quant_matmul_w8a8_plain_vs_pallas(dtype, m):
    jq = jqz.quantize(jnp.asarray(rnd(30, (128, 32), 0.5)), 8)
    jx, px = both(rnd(31, (m, 128), 2.0), dtype)
    want = jops.quant_matmul_w8a8(jx, jq, backend="interpret", bk=64, bn=16)
    got = pops.quant_matmul_w8a8(px, port_qt(jq))
    # the reference's own oracle: int32 accumulation, same dequant
    oracle = jops.quant_matmul_w8a8(jx, jq, backend="ref")
    atol, rtol = TOL[dtype]
    for ref_out in (want, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref_out).astype(np.float32),
                                   rtol=rtol, atol=atol)


def test_w8a8_plain_accumulates_exactly():
    """The plain version must not accumulate in f32: at k = 6912 x 127^2
    the partial sums pass 2^24. Against an int64 numpy product."""
    rng = np.random.default_rng(5)
    w = rng.integers(-127, 128, (6912, 8)).astype(np.int8)
    x = np.full((2, 6912), 127.0, np.float32)
    x[1, ::2] = -127.0
    qt = pqz.QuantizedTensor(data=torch.from_numpy(w),
                             scale=torch.ones(8), bits=8, shape=(6912, 8))
    got = pref.quant_matmul_w8a8_ref(torch.from_numpy(x), qt)
    xq, xs = pqz.quantize_activations_int8(torch.from_numpy(x))
    exact = xq.numpy().astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(
        got.numpy(), exact.astype(np.float32) * xs.numpy())


@pytest.mark.parametrize("spec", [dict(bits=4), dict(bits=8, act_bits=8),
                                  dict(bits=2, act_bits=8)])
def test_apply_packed_qt_matches_jax(spec):
    w, x = rnd(40, (96, 64), 0.3), rnd(41, (2, 7, 96))
    jspec, pspec = jkr.KratosSpec(**spec), pkr.KratosSpec(**spec)
    jp = jkr.pack_linear({"w": jnp.asarray(w)}, jspec)
    want = jkr.apply_packed(jp.buffers, jnp.asarray(x), jp.spec, 96, 64)
    pl = pkr.pack_linear({"w": torch.from_numpy(w)}, pspec)
    pops.reset_launch_counts()
    got = pkr.apply_packed(pl, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # CPU tensors take the plain versions: no kernel launched
    assert not any(pops.launch_counts().values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_kernels_match_plain_versions(cuda_device, dtype):
    """quant_matmul at every width and quant_matmul_w8a8 against their
    plain versions on the card, at skinny and ragged shapes."""
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dt == torch.float32 else (1e-3, 2.0 ** -7)
    w = torch.from_numpy(rnd(1, (256, 96), 0.1)).to(cuda_device)
    for m in (1, 5, 77):
        x = torch.from_numpy(rnd(0, (m, 256))).to(cuda_device).to(dt)
        for bits in (8, 4, 2, 1):
            qt = pqz.quantize(w, bits)
            pops.reset_launch_counts()
            got = pops.quant_matmul(x, qt)
            assert pops.launch_counts()["quant_matmul"] == 1
            torch.testing.assert_close(
                got.float(), pref.quant_matmul_ref(x, qt).float(),
                rtol=rtol, atol=atol)
        qt = pqz.quantize(w, 8)
        torch.testing.assert_close(
            pops.quant_matmul_w8a8(x, qt).float(),
            pref.quant_matmul_w8a8_ref(x, qt).float(), rtol=rtol, atol=atol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_cuda_quant_matmul_both_forms(cuda_device, dtype, bits):
    """quant_matmul's decode form (cluster split-K over 32-bit code words)
    and prefill form (codes copied raw, unpacked once per stage) against the
    plain version: ragged p, n not a multiple of the split, one launch per
    call, two calls bitwise equal."""
    from repro_torch.kernels import gemm_plan
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dt == torch.float32 else (1e-3, 2.0 ** -7)
    for n, p in ((256, 96), (200, 100), (520, 288), (8192, 288)):
        w = torch.from_numpy(rnd(1, (n, p), n ** -0.5)).to(cuda_device)
        qt = pqz.quantize(w, bits)
        for m in (1, 8, 16, 17, 77):
            assert gemm_plan.plan(m, n, p, bits=bits).form == \
                ("gemv" if m <= 16 else "tile")
            x = torch.from_numpy(rnd(m, (m, n))).to(cuda_device).to(dt)
            pops.reset_launch_counts()
            got = pops.quant_matmul(x, qt)
            assert pops.launch_counts()["quant_matmul"] == 1
            torch.testing.assert_close(
                got.float(), pref.quant_matmul_ref(x, qt).float(), rtol=rtol,
                atol=atol, msg=lambda s: f"m={m} n={n} p={p}: {s}")
            assert torch.equal(got, pops.quant_matmul(x, qt))
    torch.cuda.synchronize()
