"""Block-sparse tree GEMM: wrapper of `csrc/bsr_matmul.cu`.

Replaces `repro.kernels.bsr_matmul.bsr_matmul`. The (n_pb, nnz) index
table is an int32 tensor on the device (made once at pack time); the
kernel reads it itself. On the card the launch form (cluster split-K GEMV,
pipelined tile, or the tiled mainloop for blocks neither takes) comes from
`gemm_plan.bsr_plan` with bits = 0. CPU tensors take
`ref.bsr_matmul_ref`.

`bsr_matmul_experts` is the same kernel batched over a stack of experts
that share one plan (an MoE layer's routed projection): one launch, the
expert index a grid axis. It replaces the JAX package's `jax.vmap` of
`bsr_matmul` over its experts (`repro.models.moe._expert_ffn`), which
adds a grid axis to the Pallas call. CPU tensors take
`ref.bsr_matmul_experts_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, gemm_plan
from repro_torch.kernels.ref import bsr_matmul_experts_ref, bsr_matmul_ref

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("bsr_matmul").bsr_matmul_launch
    fn.argtypes = [_c, _c, _c, _c] + [_i] * 13 + [_c]
    fn.restype = _i
    return fn


@functools.cache
def _lib_experts():
    fn = build.load("bsr_matmul").bsr_matmul_experts_launch
    fn.argtypes = [_c, _c, _c, _c] + [_i] * 14 + [_c]
    fn.restype = _i
    return fn


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """x: (m, n); blocks: (n_pb, nnz, bk, bn); indices: int32 (n_pb, nnz)
    -> (m, n_pb * bn) in x's dtype."""
    build.check_autograd("bsr_matmul", x, blocks)
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
    pl = gemm_plan.bsr_plan(m, n_pb, nnz, bk, bn, 0, x.element_size())
    y = torch.empty((m, n_pb * bn), dtype=x.dtype, device=x.device)
    rc = _lib()(x.data_ptr(), blocks.data_ptr(), indices.data_ptr(),
                y.data_ptr(), m, n, n_pb, nnz, bk, bn,
                int(x.dtype == torch.bfloat16), pl.form_id, pl.bm, pl.bn,
                pl.split, pl.k_per_split, pl.smem_bytes,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "bsr_matmul")
    bsr_matmul.launches += 1
    return y


bsr_matmul.launches = 0


def bsr_matmul_experts(x: torch.Tensor, blocks: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """x: (E, m, n); blocks: (E, n_pb, nnz, bk, bn), one plan for every
    expert; indices: int32 (n_pb, nnz) -> (E, m, n_pb * bn) in x's dtype,
    in one launch."""
    build.check_autograd("bsr_matmul_experts", x, blocks)
    e, m, n = x.shape
    e_w, n_pb, nnz, bk, bn = blocks.shape
    if e_w != e:
        raise ValueError(f"bsr_matmul_experts: x has {e} experts, blocks "
                         f"{e_w}")
    if n % bk:
        raise ValueError(f"bsr_matmul_experts: n={n} not divisible by "
                         f"bk={bk}")
    if tuple(indices.shape) != (n_pb, nnz):
        raise ValueError(f"bsr_matmul_experts: indices "
                         f"{tuple(indices.shape)} vs blocks "
                         f"{tuple(blocks.shape)}")
    if x.device.type == "cpu":
        return bsr_matmul_experts_ref(x, blocks, indices)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_matmul_experts: unsupported device {x.device}")
    if blocks.dtype != x.dtype or indices.dtype != torch.int32:
        raise TypeError(f"bsr_matmul_experts: x {x.dtype}, blocks "
                        f"{blocks.dtype}, indices {indices.dtype} (want "
                        "int32)")
    build.check_cuda_operands("bsr_matmul_experts", x.dtype, x, blocks,
                              indices)
    pl = gemm_plan.bsr_plan(m, n_pb, nnz, bk, bn, 0, x.element_size(),
                            batch=e)
    y = torch.empty((e, m, n_pb * bn), dtype=x.dtype, device=x.device)
    rc = _lib_experts()(x.data_ptr(), blocks.data_ptr(), indices.data_ptr(),
                        y.data_ptr(), e, m, n, n_pb, nnz, bk, bn,
                        int(x.dtype == torch.bfloat16), pl.form_id, pl.bm,
                        pl.bn, pl.split, pl.k_per_split, pl.smem_bytes,
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "bsr_matmul_experts")
    bsr_matmul_experts.launches += 1
    return y


bsr_matmul_experts.launches = 0
