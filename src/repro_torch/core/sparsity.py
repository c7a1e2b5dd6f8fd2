"""Balanced block sparsity (the TPU and GPU granule for the paper's
fine-grained sparsity).

Port of `repro.core.sparsity`. A weight `w: (n_in, n_out)` is tiled into
`bk x bn` blocks; every output-column block keeps the same number `nnz` of
k-blocks, drawn from a shuffle seeded by `SeedSequence([seed, n_in, n_out,
bk, bn])` exactly as the JAX package draws it, so both packages pick the
same blocks.

    plan.indices: int32 (n_pb, nnz), sorted (numpy, host)
    packed blocks: (n_pb, nnz, bk, bn)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BlockSparsePlan:
    """Static description of a balanced block-sparse weight."""

    n_in: int
    n_out: int
    bk: int
    bn: int
    nnz: int                 # kept k-blocks per output-column block
    indices: np.ndarray      # int32 (n_pb, nnz), sorted along axis -1
    seed: int

    @property
    def n_kb(self) -> int:
        return self.n_in // self.bk

    @property
    def n_pb(self) -> int:
        return self.n_out // self.bn

    @property
    def sparsity(self) -> float:
        return 1.0 - self.nnz / self.n_kb

    @property
    def dense_flops_fraction(self) -> float:
        return self.nnz / self.n_kb

    def __repr__(self) -> str:
        return (f"BlockSparsePlan({self.n_in}x{self.n_out}, "
                f"block={self.bk}x{self.bn}, nnz={self.nnz}/{self.n_kb}, "
                f"sparsity={self.sparsity:.3f}, seed={self.seed})")


def nnz_for_sparsity(n_kb: int, sparsity: float) -> int:
    """Kept k-blocks per output block, clamped to [1, n_kb]."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    return max(1, min(n_kb, int(round((1.0 - sparsity) * n_kb))))


def make_plan(n_in: int, n_out: int, *, bk: int = 128, bn: int = 128,
              sparsity: float = 0.0, seed: int = 0) -> BlockSparsePlan:
    """Balanced block-sparse plan with seeded-shuffled block positions."""
    if n_in % bk:
        raise ValueError(f"n_in={n_in} not divisible by bk={bk}")
    if n_out % bn:
        raise ValueError(f"n_out={n_out} not divisible by bn={bn}")
    n_kb = n_in // bk
    n_pb = n_out // bn
    nnz = nnz_for_sparsity(n_kb, sparsity)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, n_in, n_out, bk, bn]))
    idx = np.empty((n_pb, nnz), dtype=np.int32)
    for j in range(n_pb):
        idx[j] = np.sort(rng.permutation(n_kb)[:nnz]).astype(np.int32)
    return BlockSparsePlan(n_in=n_in, n_out=n_out, bk=bk, bn=bn, nnz=nnz,
                           indices=idx, seed=seed)


def plan_mask(plan: BlockSparsePlan, dtype=np.float32) -> np.ndarray:
    """Dense 0/1 mask of shape (n_in, n_out) described by the plan."""
    m = np.zeros((plan.n_kb, plan.n_pb), dtype=dtype)
    for j in range(plan.n_pb):
        m[plan.indices[j], j] = 1.0
    return np.repeat(np.repeat(m, plan.bk, axis=0), plan.bn, axis=1)


def pack_blocks(w: torch.Tensor, plan: BlockSparsePlan) -> torch.Tensor:
    """Gather the kept blocks of a dense (n_in, n_out) weight:
    (n_pb, nnz, bk, bn), contiguous."""
    if tuple(w.shape) != (plan.n_in, plan.n_out):
        raise ValueError(f"weight shape {tuple(w.shape)} != plan "
                         f"({plan.n_in},{plan.n_out})")
    wb = w.reshape(plan.n_kb, plan.bk, plan.n_pb, plan.bn).permute(2, 0, 1, 3)
    idx = torch.as_tensor(plan.indices, dtype=torch.long, device=w.device)
    rows = torch.arange(plan.n_pb, device=w.device)[:, None]
    return wb[rows, idx].contiguous()


def sparsify_init(w: torch.Tensor, plan: BlockSparsePlan) -> torch.Tensor:
    """Zero the pruned blocks of a dense init."""
    return w * torch.as_tensor(plan_mask(plan), dtype=w.dtype, device=w.device)
