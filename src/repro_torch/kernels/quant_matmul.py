"""Quantized GEMMs: wrappers of `csrc/quant_matmul.cu`.

Replaces the three kernels of `repro.kernels.quant_matmul`:
`quant_matmul` (weight-only w8/w4/w2/w1, the 'qt' buffer),
`quant_matmul_w8a8` (int8 x int8, `act_bits=8`) and `bsr_quant_matmul`
(block-sparse x quantized). CPU tensors take the plain versions of
`kernels.ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import build, gemm_plan
from repro_torch.kernels.ref import (bsr_quant_matmul_ref, quant_matmul_ref,
                                     quant_matmul_w8a8_ref)

_c = ctypes.c_void_p
_i = ctypes.c_int


def _bind(name, argtypes):
    fn = getattr(build.load("quant_matmul"), name)
    fn.argtypes = argtypes
    fn.restype = _i
    return fn


@functools.cache
def _lib_qt():
    return _bind("quant_matmul_launch", [_c, _c, _c, _c, _i, _i, _i, _i, _i,
                                         _i, _i, _i, _i, _i, _i, _c])


@functools.cache
def _lib_w8a8():
    return _bind("quant_matmul_w8a8_launch",
                 [_c, _c, _c, _c, _c, _i, _i, _i, _i, _c])


@functools.cache
def _lib_bsr():
    return _bind("bsr_quant_matmul_launch",
                 [_c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _i, _c])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_qt(name: str, x: torch.Tensor, qt: qz.QuantizedTensor) -> None:
    qz._check_bits(qt.bits)
    n, p = qt.shape
    if x.ndim != 2 or x.shape[1] != n:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs weight {qt.shape}")
    if tuple(qt.data.shape) != (n // qz.VALUES_PER_BYTE[qt.bits], p) \
            or tuple(qt.scale.shape) != (p,):
        raise ValueError(f"{name}: codes {tuple(qt.data.shape)}, scale "
                         f"{tuple(qt.scale.shape)} vs weight {qt.shape}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and (qt.data.dtype != torch.int8
                                    or qt.scale.dtype != torch.float32):
        raise TypeError(f"{name}: codes {qt.data.dtype} (int8), scale "
                        f"{qt.scale.dtype} (float32)")


def quant_matmul(x: torch.Tensor, qt: qz.QuantizedTensor) -> torch.Tensor:
    """x: (m, n) float; qt: codes int8 (n // vpb, p) + scale f32 (p,) ->
    (m, p) in x's dtype."""
    _check_qt("quant_matmul", x, qt)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qt)
    build.check_cuda_operands("quant_matmul", x.dtype, x, qt.data, qt.scale)
    m, n = x.shape
    p = qt.shape[1]
    pl = gemm_plan.plan(m, n, p, bits=qt.bits, elem=x.element_size())
    y = torch.empty((m, p), dtype=x.dtype, device=x.device)
    rc = _lib_qt()(x.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(),
                   y.data_ptr(), m, n, p, qt.bits,
                   int(x.dtype == torch.bfloat16), pl.form_id, pl.bm, pl.bn,
                   pl.split, pl.k_per_split, pl.smem_bytes, _stream(x))
    build.check(rc, "quant_matmul")
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0


def quant_matmul_w8a8(x: torch.Tensor, qt: qz.QuantizedTensor) -> torch.Tensor:
    """x: (m, n) float, quantized per row to int8 here (outside the kernel,
    as in the JAX wrapper); qt: 8-bit codes (n, p) + scale (p,) -> (m, p)
    in x's dtype."""
    _check_qt("quant_matmul_w8a8", x, qt)
    if qt.bits != 8:
        raise ValueError(f"quant_matmul_w8a8 needs 8-bit weights, got "
                         f"{qt.bits}")
    if x.device.type == "cpu":
        return quant_matmul_w8a8_ref(x, qt)
    build.check_cuda_operands("quant_matmul_w8a8", x.dtype, x, qt.data,
                              qt.scale)
    xq, xs = qz.quantize_activations_int8(x)
    m, n = x.shape
    p = qt.shape[1]
    y = torch.empty((m, p), dtype=x.dtype, device=x.device)
    rc = _lib_w8a8()(xq.data_ptr(), xs.data_ptr(), qt.data.data_ptr(),
                     qt.scale.data_ptr(), y.data_ptr(), m, n, p,
                     int(x.dtype == torch.bfloat16), _stream(x))
    build.check(rc, "quant_matmul_w8a8")
    quant_matmul_w8a8.launches += 1
    return y


quant_matmul_w8a8.launches = 0


def bsr_quant_matmul(x: torch.Tensor, qblocks: torch.Tensor,
                     scales: torch.Tensor, indices: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """x: (m, n) float; qblocks: int8 (n_pb, nnz, bk // vpb, bn); scales:
    f32 (n_pb, bn); indices: int32 (n_pb, nnz) -> (m, n_pb * bn)."""
    qz._check_bits(bits)
    m, n = x.shape
    n_pb, nnz, bkp, bn = qblocks.shape
    bk = bkp * qz.VALUES_PER_BYTE[bits]
    if n % bk:
        raise ValueError(f"bsr_quant_matmul: n={n} not divisible by "
                         f"block k-extent {bk}")
    if tuple(scales.shape) != (n_pb, bn) or tuple(indices.shape) != (n_pb, nnz):
        raise ValueError(f"bsr_quant_matmul: scales {tuple(scales.shape)}, "
                         f"indices {tuple(indices.shape)} vs qblocks "
                         f"{tuple(qblocks.shape)}")
    if x.device.type == "cpu":
        return bsr_quant_matmul_ref(x, qblocks, scales, indices, bits)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_quant_matmul: unsupported device {x.device}")
    if (qblocks.dtype != torch.int8 or scales.dtype != torch.float32
            or indices.dtype != torch.int32):
        raise TypeError(f"bsr_quant_matmul: qblocks {qblocks.dtype} (int8), "
                        f"scales {scales.dtype} (float32), indices "
                        f"{indices.dtype} (int32)")
    build.check_cuda_operands("bsr_quant_matmul", x.dtype, x, qblocks, scales,
                        indices)
    y = torch.empty((m, n_pb * bn), dtype=x.dtype, device=x.device)
    rc = _lib_bsr()(x.data_ptr(), qblocks.data_ptr(), scales.data_ptr(),
                    indices.data_ptr(), y.data_ptr(), m, n, n_pb, nnz, bk, bn,
                    bits, int(x.dtype == torch.bfloat16), _stream(x))
    build.check(rc, "bsr_quant_matmul")
    bsr_quant_matmul.launches += 1
    return y


bsr_quant_matmul.launches = 0
