"""Plain PyTorch versions of the port's kernels (the oracles).

Same signatures as `repro.kernels.ref`. On a CPU tensor the kernel
wrappers run these; on the card `chip_smoke.py` holds each hand-written
kernel against them. Every product is taken in f32 and cast to x's dtype
once at the end — for the quantized kernel that means the scale is applied
in f32 too (the JAX oracle scales in x's dtype, which for bf16 differs
from the f32-flush kernels by about one ulp).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantize as qz


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w, f32 accumulation, x's dtype out."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _gather_x(x: torch.Tensor, indices: torch.Tensor, bk: int) -> torch.Tensor:
    """(m, n) -> (m, n_pb, nnz, bk): the k-blocks each output block reads."""
    m, n = x.shape
    xb = x.float().reshape(m, n // bk, bk)
    return xb[:, indices.long()]


def bsr_matmul_ref(x: torch.Tensor, blocks: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """x: (m, n); blocks: (n_pb, nnz, bk, bn); indices: int (n_pb, nnz)."""
    m = x.shape[0]
    n_pb, nnz, bk, bn = blocks.shape
    xg = _gather_x(x, indices, bk)
    y = torch.einsum("mjtk,jtkn->mjn", xg, blocks.float())
    return y.reshape(m, n_pb * bn).to(x.dtype)


def bsr_quant_matmul_ref(x: torch.Tensor, qblocks: torch.Tensor,
                         scales: torch.Tensor, indices: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """qblocks: int8 (n_pb, nnz, bk // vpb, bn) packed codes; scales: f32
    (n_pb, bn) per output channel."""
    m = x.shape[0]
    n_pb, nnz, bkp, bn = qblocks.shape
    vpb = qz.VALUES_PER_BYTE[bits]
    codes = qz.unpack_codes(qblocks.reshape(n_pb * nnz, bkp, bn)
                            .transpose(0, 1), bits)          # (bk, n_pb*nnz, bn)
    blocks = codes.transpose(0, 1).reshape(n_pb, nnz, bkp * vpb, bn)
    xg = _gather_x(x, indices, bkp * vpb)
    y = torch.einsum("mjtk,jtkn->mjn", xg, blocks.float())
    return (y * scales.float()[None]).reshape(m, n_pb * bn).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (b, h, s, d) with equal head counts."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
