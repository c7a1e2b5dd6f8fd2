"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of `repro.kernels.ops` (same contracts as its `matmul`,
`bsr_matmul`, `quant_matmul`, `quant_matmul_w8a8`, `bsr_quant_matmul`,
`flash_attention`, `paged_attention` and `ssm_scan`), plus
`bsr_matmul_experts`, `bsr_matmul` batched over an MoE layer's experts
(the counterpart of the JAX package's vmap of `bsr_matmul`). The JAX `backend`
knob has no counterpart: a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes its plain version, inside each wrapper.
`launch_counts` / `reset_launch_counts` read and zero the wrappers'
launch counters, so a run can show which kernels it went through. A CUDA
graph calls no wrapper when it replays: `captured_launches` takes the
calls recorded at capture off the counters and `count_replay` adds them
back at every replay, so the counts stay launches on the device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from repro_torch.core import quantize as qz
from repro_torch.kernels.bsr_matmul import bsr_matmul as _bsr
from repro_torch.kernels.bsr_matmul import bsr_matmul_experts as _bsr_e
from repro_torch.kernels.dense_matmul import dense_matmul as _dense
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention import paged_flash_attention as _paged
from repro_torch.kernels.quant_matmul import bsr_quant_matmul as _bsr_quant
from repro_torch.kernels.quant_matmul import quant_matmul as _qmm
from repro_torch.kernels.quant_matmul import quant_matmul_w8a8 as _w8a8
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm

KERNELS = {"dense_matmul": _dense, "bsr_matmul": _bsr, "quant_matmul": _qmm,
           "quant_matmul_w8a8": _w8a8, "bsr_quant_matmul": _bsr_quant,
           "flash_attention": _fa, "paged_flash_attention": _paged,
           "ssm_scan": _ssm, "bsr_matmul_experts": _bsr_e}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields a dict that, on exit, holds the
    wrapper calls the capture recorded by kernel (one replay's launches),
    and restores the counters, since a capture launches nothing."""
    before = launch_counts()
    per_replay: Dict[str, int] = {}
    try:
        yield per_replay
    finally:
        for name, fn in KERNELS.items():
            if fn.launches != before[name]:
                per_replay[name] = fn.launches - before[name]
            fn.launches = before[name]


def count_replay(per_replay: Dict[str, int]) -> None:
    """One replay of a captured graph: its kernels launched once more."""
    for name, n in per_replay.items():
        KERNELS[name].launches += n


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense GEMM ('systolic' analogue): (m, n) @ (n, p)."""
    return _dense(x.contiguous(), w)


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """Block-sparse tree GEMM; FLOPs and weight bytes scale with
    (1 - sparsity)."""
    return _bsr(x.contiguous(), blocks, indices)


def bsr_matmul_experts(x: torch.Tensor, blocks: torch.Tensor,
                       indices: torch.Tensor) -> torch.Tensor:
    """Block-sparse tree GEMM of every expert at once: x (E, m, n),
    blocks (E, n_pb, nnz, bk, bn) over one shared index table."""
    return _bsr_e(x.contiguous(), blocks, indices)


def quant_matmul(x: torch.Tensor, qt: qz.QuantizedTensor) -> torch.Tensor:
    """Weight-only quantized GEMM (w{8,4,2,1}a16)."""
    return _qmm(x.contiguous(), qt)


def quant_matmul_w8a8(x: torch.Tensor, qt: qz.QuantizedTensor) -> torch.Tensor:
    """int8 x int8 GEMM: per-row activation codes, int32 accumulation."""
    return _w8a8(x.contiguous(), qt)


def bsr_quant_matmul(x: torch.Tensor, qblocks: torch.Tensor,
                     scales: torch.Tensor, indices: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Sparse + quantized tree GEMM (pruning x quantization compounded)."""
    return _bsr_quant(x.contiguous(), qblocks, scales, indices, bits)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, h, sq, d); k, v: (b, h_kv, skv, d). Returns (b, h, sq, d)."""
    b, h, sq, d = q.shape
    _, h_kv, skv, _ = k.shape
    out = _fa(q.reshape(b * h, sq, d).contiguous(),
              k.reshape(b * h_kv, skv, d).contiguous(),
              v.reshape(b * h_kv, skv, d).contiguous(), causal=causal, window=window,
              softcap=softcap, q_offset=q_offset, scale=scale)
    return out.reshape(b, h, sq, d)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    last: torch.Tensor, *, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Page-table-native decode attention. q: (b, h, sq, d); k_pages,
    v_pages: (n_pages, h_kv, P, d); table: int32 (b, pp) page ids; last:
    int32 (b,) position of each slot's final query row. Returns
    (b, h, sq, d). Causal by construction."""
    return _paged(q.contiguous(), k_pages, v_pages, table, last,
                  window=window, softcap=softcap, scale=scale)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor):
    """Selective-scan (Mamba-1) recurrence. u, dt: (B, S, di); b, c:
    (B, S, st); a: (di, st) f32. Returns (y in u's dtype, h_final
    (B, di, st) f32)."""
    return _ssm(u.contiguous(), dt.contiguous(), b.contiguous(),
                c.contiguous(), a.contiguous())
