"""Block-sparse x quantized GEMM: wrapper of `csrc/quant_matmul.cu`.

Replaces `repro.kernels.quant_matmul.bsr_quant_matmul`. The weight-only
`quant_matmul` and `quant_matmul_w8a8` kernels of the same JAX module are
not ported yet (ROADMAP.md queue 2, items 2 and 5). CPU tensors take
`ref.bsr_quant_matmul_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels import build
from repro_torch.kernels.ref import bsr_quant_matmul_ref

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("quant_matmul").bsr_quant_matmul_launch
    fn.argtypes = [_c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


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
    rc = _lib()(x.data_ptr(), qblocks.data_ptr(), scales.data_ptr(),
                indices.data_ptr(), y.data_ptr(), m, n, n_pb, nnz, bk, bn,
                bits, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "bsr_quant_matmul")
    bsr_quant_matmul.launches += 1
    return y


bsr_quant_matmul.launches = 0
