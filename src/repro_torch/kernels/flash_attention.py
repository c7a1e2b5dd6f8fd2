"""Flash attention: wrapper of `csrc/flash_attention.cu`.

Replaces `repro.kernels.flash_attention.flash_attention` (the paged
decode kernel of the same JAX module is not ported yet: ROADMAP.md queue
2, item 7). Layout as in the JAX kernel: q (bh, sq, d), k and v
(bh_kv, skv, d), GQA head bh -> bh // (bh / bh_kv). Any sq, skv >= 1 (the
kernel masks ragged tails); d <= 128. CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

MAX_HEAD_DIM = 128

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


@functools.cache
def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _f, _i, _i, _f, _i,
                   _i, _c]
    fn.restype = _i
    return fn


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          q_offset=0, scale=None) -> torch.Tensor:
    """The kernel's plain version on the flattened-head layout."""
    g = q.shape[0] // k.shape[0]
    kk = k.repeat_interleave(g, dim=0) if g > 1 else k
    vv = v.repeat_interleave(g, dim=0) if g > 1 else v
    return attention_ref(q[None], kk[None], vv[None], causal=causal,
                         window=window, softcap=softcap, q_offset=q_offset,
                         scale=scale)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    bh, sq, d = q.shape
    bh_kv, skv, d2 = k.shape
    if bh % bh_kv or d2 != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    build.check_cuda_operands("flash_attention", q.dtype, q, k, v)
    scale = (d ** -0.5) if scale is None else scale
    o = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                bh_kv, sq, skv, d, float(scale), int(causal),
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap), int(q_offset),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
