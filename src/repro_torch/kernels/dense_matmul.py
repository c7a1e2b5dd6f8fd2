"""Dense GEMM y = x @ w: wrapper of `csrc/dense_matmul.cu`.

Replaces `repro.kernels.dense_matmul.dense_matmul`. A CUDA tensor launches
the hand-written kernel on the current stream; a CPU tensor takes the plain
version (`ref.dense_matmul_ref`). Any m >= 1: the kernel masks the ragged
row edge instead of padding rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dense_matmul_ref

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("dense_matmul")
    fn = lib.dense_matmul_launch
    fn.argtypes = [_c, _c, _c, _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (m, n), w: (n, p), same float dtype -> (m, p) in x's dtype."""
    m, n = x.shape
    n2, p = w.shape
    if n != n2:
        raise ValueError(f"dense_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return dense_matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dense_matmul: unsupported device {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"dense_matmul: x {x.dtype} vs w {w.dtype}")
    build.check_cuda_operands("dense_matmul", x.dtype, x, w)
    y = torch.empty((m, p), dtype=x.dtype, device=x.device)
    rc = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, p,
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "dense_matmul")
    dense_matmul.launches += 1
    return y


dense_matmul.launches = 0
