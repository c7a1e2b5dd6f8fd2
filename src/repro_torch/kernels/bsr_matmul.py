"""Block-sparse tree GEMM: wrapper of `csrc/bsr_matmul.cu`.

Replaces `repro.kernels.bsr_matmul.bsr_matmul`. The (n_pb, nnz) index
table is an int32 tensor on the device (made once at pack time); the
kernel reads it itself. CPU tensors take `ref.bsr_matmul_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bsr_matmul_ref

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("bsr_matmul").bsr_matmul_launch
    fn.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """x: (m, n); blocks: (n_pb, nnz, bk, bn); indices: int32 (n_pb, nnz)
    -> (m, n_pb * bn) in x's dtype."""
    m, n = x.shape
    n_pb, nnz, bk, bn = blocks.shape
    if n % bk:
        raise ValueError(f"bsr_matmul: n={n} not divisible by bk={bk}")
    if tuple(indices.shape) != (n_pb, nnz):
        raise ValueError(f"bsr_matmul: indices {tuple(indices.shape)} vs "
                         f"blocks {tuple(blocks.shape)}")
    if x.device.type == "cpu":
        return bsr_matmul_ref(x, blocks, indices)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul: unsupported device {x.device}")
    if blocks.dtype != x.dtype or indices.dtype != torch.int32:
        raise TypeError(f"bsr_matmul: x {x.dtype}, blocks {blocks.dtype}, "
                        f"indices {indices.dtype} (want int32)")
    build.check_cuda_operands("bsr_matmul", x.dtype, x, blocks, indices)
    y = torch.empty((m, n_pb * bn), dtype=x.dtype, device=x.device)
    rc = _lib()(x.data_ptr(), blocks.data_ptr(), indices.data_ptr(),
                y.data_ptr(), m, n, n_pb, nnz, bk, bn,
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "bsr_matmul")
    bsr_matmul.launches += 1
    return y


bsr_matmul.launches = 0
