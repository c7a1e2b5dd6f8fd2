"""Port parity, kernels: each plain version of `repro_torch.kernels`
(what the wrappers run on a CPU tensor) against the JAX Pallas kernel in
interpret mode, at the tolerances of tests/test_kernels.py (1e-4 GEMMs,
2e-3 attention). The hand-written CUDA kernels themselves are held to the
plain versions on the card (`cuda` marker; `python3 chip_smoke.py` runs
the same comparison at the full-width shapes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import quantize as jqz
from repro.core import sparsity as jsp
from repro.kernels import ops as jops
from repro_torch.core import sparsity as psp
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _qblocks(w, plan, bits):
    """Packed codes + scales through the JAX package (the reference)."""
    scale = jqz.compute_scale(jnp.asarray(w), bits)
    codes = jqz.quantize_values(jnp.asarray(w), scale, bits)
    cb = jsp.pack_blocks(codes, plan)
    n_pb, nnz, bk, bn = cb.shape
    vpb = jqz.VALUES_PER_BYTE[bits]
    packed = jax.vmap(lambda b: jqz.pack_codes(b, bits))(
        cb.reshape(n_pb * nnz, bk, bn)).reshape(n_pb, nnz, bk // vpb, bn)
    return np.array(packed), np.array(scale).reshape(n_pb, bn)


@pytest.mark.parametrize("m,n,p", [(16, 64, 48), (1, 64, 32), (3, 64, 32),
                                   (13, 128, 128)])
def test_dense_matmul_plain_vs_pallas(m, n, p):
    x, w = rnd(0, (m, n)), rnd(1, (n, p))
    want = jops.matmul(jnp.asarray(x), jnp.asarray(w), backend="interpret",
                       bk=32, bn=16)
    got = pops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("m", [16, 4])
@pytest.mark.parametrize("sparsity,bk,bn", [(0.5, 8, 8), (0.75, 16, 16),
                                            (0.3, 8, 16)])
def test_bsr_matmul_plain_vs_pallas(m, sparsity, bk, bn):
    plan = jsp.make_plan(64, 48, bk=bk, bn=bn, sparsity=sparsity, seed=3)
    w = rnd(2, (64, 48)) * jsp.plan_mask(plan)
    x = rnd(3, (m, 64))
    blocks = np.array(jsp.pack_blocks(jnp.asarray(w), plan))
    want = jops.bsr_matmul(jnp.asarray(x), jnp.asarray(blocks),
                           jnp.asarray(plan.indices), backend="interpret",
                           bm=8)
    got = pops.bsr_matmul(torch.from_numpy(x), torch.from_numpy(blocks),
                          torch.from_numpy(plan.indices))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("sparsity,m", [(0.5, 16), (0.75, 4)])
def test_bsr_quant_matmul_plain_vs_pallas(bits, sparsity, m):
    plan = jsp.make_plan(64, 32, bk=16, bn=16, sparsity=sparsity, seed=9)
    w, x = rnd(8, (64, 32), 0.5), rnd(9, (m, 64))
    packed, scales = _qblocks(w, plan, bits)
    want = jops.bsr_quant_matmul(jnp.asarray(x), jnp.asarray(packed),
                                 jnp.asarray(scales),
                                 jnp.asarray(plan.indices), bits,
                                 backend="interpret", bm=8)
    got = pops.bsr_quant_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scales),
                                torch.from_numpy(plan.indices), bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("h,h_kv,sq,skv,q_offset,causal,window,softcap", [
    (4, 4, 128, 128, 0, True, None, None),
    (4, 4, 128, 128, 0, True, 32, None),
    (4, 4, 128, 128, 0, True, None, 30.0),
    (4, 4, 128, 128, 0, False, None, None),
    (8, 2, 128, 128, 0, True, None, None),          # GQA
    (8, 2, 77, 77, 0, True, 16, 50.0),              # ragged sq, window+cap
    (2, 2, 64, 128, 64, True, None, None),          # q_offset (decode tail)
])
def test_flash_attention_plain_vs_pallas(h, h_kv, sq, skv, q_offset, causal,
                                         window, softcap):
    b, d = 2, 16
    q, k, v = rnd(10, (b, h, sq, d)), rnd(11, (b, h_kv, skv, d)), \
        rnd(12, (b, h_kv, skv, d))
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap, q_offset=q_offset,
        backend="interpret", bq=64 if sq % 64 == 0 else sq,
        bkv=64 if skv % 64 == 0 else skv)
    got = pops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    """Each hand-written kernel against its plain version on the card, at
    skinny and ragged shapes; bf16 within one bf16 ulp of the f32 product."""
    dt = getattr(torch, dtype)
    # (atol, rtol): bf16 within one bf16 ulp of the f32 product
    atol, rtol = (1e-4, 1e-4) if dt == torch.float32 else (1e-3, 2.0 ** -7)
    dev = cuda_device
    t = lambda a: torch.from_numpy(a).to(dev)
    for m in (1, 5, 77):
        x, w = t(rnd(0, (m, 256))).to(dt), t(rnd(1, (256, 96), 0.1)).to(dt)
        pops.reset_launch_counts()
        got = pops.matmul(x, w)
        assert pops.launch_counts()["dense_matmul"] == 1
        torch.testing.assert_close(got.float(), pref.dense_matmul_ref(x, w).float(),
                                   rtol=rtol, atol=atol)
        plan = psp.make_plan(256, 96, bk=32, bn=16, sparsity=0.5)
        idx = t(plan.indices)
        blocks = psp.pack_blocks(w, plan)
        torch.testing.assert_close(
            pops.bsr_matmul(x, blocks, idx).float(),
            pref.bsr_matmul_ref(x, blocks, idx).float(), rtol=rtol, atol=atol)
        for bits in (8, 4, 2, 1):
            packed, scales = _qblocks(rnd(1, (256, 96), 0.1), plan, bits)
            qb, sc = t(packed), t(np.ascontiguousarray(scales))
            torch.testing.assert_close(
                pops.bsr_quant_matmul(x, qb, sc, idx, bits).float(),
                pref.bsr_quant_matmul_ref(x, qb, sc, idx, bits).float(),
                rtol=rtol, atol=atol)
    for sq, window, cap in ((77, None, None), (130, 64, 50.0)):
        q = t(rnd(10, (1, 8, sq, 80))).to(dt)
        k, v = t(rnd(11, (1, 2, sq, 80))).to(dt), t(rnd(12, (1, 2, sq, 80))).to(dt)
        got = pops.flash_attention(q, k, v, window=window, softcap=cap)
        kk, vv = k.repeat_interleave(4, 1), v.repeat_interleave(4, 1)
        want = pref.attention_ref(q, kk, vv, window=window, softcap=cap)
        # bf16: each side rounds p to bf16 (the kernel before normalising)
        fa_atol, fa_rtol = (2e-3, 2e-3) if dt == torch.float32 else \
            (8e-3, 2.0 ** -7)
        torch.testing.assert_close(got.float(), want.float(), rtol=fa_rtol,
                                   atol=fa_atol)
    torch.cuda.synchronize()
