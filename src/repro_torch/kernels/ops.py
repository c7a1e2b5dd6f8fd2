"""Public kernel entry points, dispatched by the tensor's device.

Counterpart of `repro.kernels.ops` (same contracts as its `matmul`,
`bsr_matmul`, `bsr_quant_matmul` and `flash_attention`). The JAX `backend`
knob has no counterpart: a CUDA tensor launches the hand-written Hopper
kernel, a CPU tensor takes its plain version, inside each wrapper.
`launch_counts` / `reset_launch_counts` read and zero the wrappers'
launch counters, so a run can show which kernels it went through.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.bsr_matmul import bsr_matmul as _bsr
from repro_torch.kernels.dense_matmul import dense_matmul as _dense
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.quant_matmul import bsr_quant_matmul as _bsr_quant

KERNELS = {"dense_matmul": _dense, "bsr_matmul": _bsr,
           "bsr_quant_matmul": _bsr_quant, "flash_attention": _fa}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense GEMM ('systolic' analogue): (m, n) @ (n, p)."""
    return _dense(x.contiguous(), w)


def bsr_matmul(x: torch.Tensor, blocks: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """Block-sparse tree GEMM; FLOPs and weight bytes scale with
    (1 - sparsity)."""
    return _bsr(x.contiguous(), blocks, indices)


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
