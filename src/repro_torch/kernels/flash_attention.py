"""Flash attention: wrappers of `csrc/flash_attention.cu` (prefill) and
`csrc/paged_attention.cu` (decode through the page table).

Replaces the two kernels of `repro.kernels.flash_attention`:
`flash_attention` (prefill; layout as in the JAX kernel: q (bh, sq, d),
k and v (bh_kv, skv, d), GQA head bh -> bh // (bh / bh_kv), any
sq, skv >= 1) and `paged_flash_attention` (decode through a page table).
Both take head_dim d <= 256. CPU tensors take the plain versions.

`fa_plan` fixes the prefill kernel's launch from (d, dtype) alone: the
padded head dim DP its instantiation takes, the 64-row q tile of 4 warps,
the KV tile and the shared memory of its 2-stage K/V ring. `paged_plan`
fixes the decode kernel's (`csrc/paged_attention.cu`) from sizes the host
knows, never from the device-resident clocks `last`: the padded head dim,
the 16-row query tiles, how many CTAs of a cluster split each (slot, kv
head, query tile)'s live pages, the stages of each warp's K/V ring and the
shared memory. The C launchers check the plans against their own
instantiations, so the choice runs and is tested on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref, paged_attention_ref

MAX_HEAD_DIM = 256
FA_DP = (16, 32, 64, 80, 96, 128, 192, 256)   # instantiated padded head dims
FA_WARPS = 4
FA_BQ = 16 * FA_WARPS      # q rows of a CTA, 16 per warp
FA_STAGES = 2              # K/V cp.async ring
FA_BKV = (64, 32, 16)      # KV tiles, widest first
MAX_SMEM = 232_448         # bytes of shared memory one CTA may use (227 KB)
# two CTAs an SM: 228 KB of the SM's shared memory, 1 KB reserved per CTA
SM_SMEM = 233_472
TWO_CTA_SMEM = (SM_SMEM - 2 * 1024) // 2
SM_COUNT = 132             # H100 SXM
PAGED_WARPS = 4            # each walks its own key tiles
PAGED_BQ = 16              # query rows of a CTA: one m16 tile (g * sq <= 16
                           # at decode fills one)
PAGED_BK = 16              # keys of a tile
PAGED_MAX_SPLIT = 8        # CTAs of a cluster (the portable limit)
PAGED_MAX_STAGES = 2       # K/V tiles in flight per warp

_c = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float


@functools.cache
def _lib():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _f, _i, _i, _f, _i,
                   _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


@functools.cache
def _lib_paged():
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = [_c, _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _i, _i, _f,
                   _i, _f, _i, _i, _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


@dataclasses.dataclass(frozen=True)
class FaPlan:
    dp: int           # head dim of the instantiation (d padded with zeros)
    bq: int           # q rows of a CTA
    bkv: int          # keys of one K/V tile
    stages: int       # K/V tiles in flight
    smem_bytes: int   # dynamic shared memory: Q tile + the K/V ring
    threads: int


def fa_smem_bytes(dp: int, bkv: int, elem: int) -> int:
    """Q (BQ rows) and STAGES K and V tiles (bkv rows each), every row dp
    elements plus 16 bytes of pad."""
    return (FA_BQ + 2 * FA_STAGES * bkv) * (dp + 16 // elem) * elem


@functools.lru_cache(maxsize=None)
def fa_plan(d: int, elem: int) -> FaPlan:
    """The prefill kernel's plan for head dim d and element size elem (4
    f32, 2 bf16): the widest KV tile whose shared memory lets two CTAs share
    an SM, else the widest that fits one."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"fa plan: head_dim {d} not in [1, {MAX_HEAD_DIM}]")
    if elem not in (4, 2):
        raise ValueError(f"fa plan: element size {elem}")
    dp = next(x for x in FA_DP if d <= x)
    bkv = next((b for b in FA_BKV
                if fa_smem_bytes(dp, b, elem) <= TWO_CTA_SMEM),
               None) or next(b for b in FA_BKV
                             if fa_smem_bytes(dp, b, elem) <= MAX_SMEM)
    return FaPlan(dp, FA_BQ, bkv, FA_STAGES, fa_smem_bytes(dp, bkv, elem),
                  32 * FA_WARPS)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    dp: int           # head dim of the instantiation (d padded with zeros)
    bq: int           # query rows of a CTA
    row_tiles: int    # query tiles of one (slot, kv head): ceil(g * sq / bq)
    split: int        # CTAs of a cluster sharing one tile's live pages
    stages: int       # K/V tiles in flight per warp
    smem_bytes: int   # dynamic shared memory
    threads: int


def paged_smem_bytes(dp: int, elem: int, stages: int) -> int:
    """Q (BQ rows of dp + 4 floats); each warp's ring of `stages` K and V
    tiles (BK rows of dp elements plus 16 bytes), whose bytes hold the
    warps' (m, l, O) partials after the walk where those are larger; and
    the CTA's merged (m, l, O), read by the cluster."""
    ldq = dp + 4
    ring = PAGED_WARPS * stages * 2 * PAGED_BK * (dp + 16 // elem) * elem
    merge = PAGED_WARPS * PAGED_BQ * (ldq + 2) * 4
    return PAGED_BQ * ldq * 4 + max(ring, merge) + PAGED_BQ * (dp + 2) * 4


def paged_ctas_per_sm(smem: int) -> int:
    """CTAs of the paged kernel that share an SM by shared memory (228 KB,
    1 KB reserved per CTA)."""
    return SM_SMEM // (smem + 1024)


@functools.lru_cache(maxsize=None)
def paged_plan(b: int, h: int, h_kv: int, sq: int, d: int, page: int,
               pp: int, elem: int) -> PagedPlan:
    """The decode kernel's plan for b slots of a pp-page table (page
    positions a page; elem the K/V element size, 4 f32 or 2 bf16).

    A warp's ring holds 2 tiles where that lets as many CTAs share an SM
    as 1 tile does, else 1. Each (slot, kv head, query tile)'s live pages
    split over the largest power-of-two number of CTAs of a cluster (at
    most 8) that keeps the grid within one wave of the card and leaves each
    warp at least 2 key tiles of a full table: more splits cost a merge and
    a wave each and shorten a walk that is already short."""
    if min(b, h, h_kv, sq, page, pp) < 1 or h % h_kv:
        raise ValueError(f"paged plan: b {b}, heads {h}/{h_kv}, sq {sq}, "
                         f"page {page}, pages {pp}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"paged plan: head_dim {d} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if elem not in (4, 2):
        raise ValueError(f"paged plan: element size {elem}")
    dp = next(x for x in FA_DP if d <= x)
    row_tiles = -(-(h // h_kv) * sq // PAGED_BQ)
    if row_tiles * h_kv > 65535 or b > 65535:
        raise ValueError(f"paged plan: grid ({row_tiles} x {h_kv}, {b})")
    stages = PAGED_MAX_STAGES if paged_ctas_per_sm(
        paged_smem_bytes(dp, elem, PAGED_MAX_STAGES)) == paged_ctas_per_sm(
        paged_smem_bytes(dp, elem, 1)) else 1
    smem = paged_smem_bytes(dp, elem, stages)
    wave = SM_COUNT * paged_ctas_per_sm(smem)
    ctas = b * h_kv * row_tiles
    full_tiles = -(-pp * page // PAGED_BK)
    split = 1
    while (split < PAGED_MAX_SPLIT and ctas * split * 2 <= wave
           and full_tiles >= split * 2 * 2 * PAGED_WARPS):
        split *= 2
    return PagedPlan(dp, PAGED_BQ, row_tiles, split, stages, smem,
                     32 * PAGED_WARPS)


def _check_options(name, window, softcap):
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")


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
    build.check_autograd("flash_attention", q, k, v)
    bh, sq, d = q.shape
    bh_kv, skv, d2 = k.shape
    if bh % bh_kv or d2 != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    _check_options("flash_attention", window, softcap)
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
    pl = fa_plan(d, q.element_size())
    o = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                bh_kv, sq, skv, d, float(scale), int(causal),
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap), int(q_offset),
                int(q.dtype == torch.bfloat16), pl.dp, pl.bkv, pl.smem_bytes,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def paged_flash_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          last: torch.Tensor, *, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention reading K/V through the page table.

    q: (b, h, sq, d) — the decode block, sq small; k_pages, v_pages:
    (n_pages, h_kv, P, d) page-major store leaves; table: int32 (b, pp)
    page ids (sink page 0); last: int32 (b,) position of each slot's final
    query row. Causal by construction. Returns (b, h, sq, d) in q's dtype;
    q and the pages may differ in dtype (f32 or bf16 each)."""
    build.check_autograd("paged_flash_attention", q, k_pages, v_pages)
    b, h, sq, d = q.shape
    n_pages, h_kv, page, d2 = k_pages.shape
    if (h % h_kv or d2 != d or tuple(v_pages.shape) != tuple(k_pages.shape)
            or table.ndim != 2 or table.shape[0] != b
            or tuple(last.shape) != (b,)):
        raise ValueError(f"paged_flash_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}, "
                         f"table {tuple(table.shape)}, last "
                         f"{tuple(last.shape)}")
    _check_options("paged_flash_attention", window, softcap)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, table, last,
                                   window=window, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: unsupported device "
                         f"{q.device}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"paged_flash_attention: head_dim {d} > "
                         f"{MAX_HEAD_DIM}")
    if v_pages.dtype != k_pages.dtype or table.dtype != torch.int32 \
            or last.dtype != torch.int32:
        raise TypeError(f"paged_flash_attention: k {k_pages.dtype}, v "
                        f"{v_pages.dtype}, table {table.dtype} (int32), last "
                        f"{last.dtype} (int32)")
    build.check_cuda_operands("paged_flash_attention", k_pages.dtype,
                              k_pages, v_pages, q, table, last)
    build.check_cuda_operands("paged_flash_attention", q.dtype, q)
    scale = (d ** -0.5) if scale is None else scale
    pp = table.shape[1]
    pl = paged_plan(b, h, h_kv, sq, d, page, pp, k_pages.element_size())
    o = torch.empty_like(q)
    rc = _lib_paged()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      table.data_ptr(), last.data_ptr(), o.data_ptr(), b, h,
                      h_kv, sq, page, pp, d, float(scale),
                      0 if window is None else int(window),
                      0.0 if softcap is None else float(softcap),
                      int(q.dtype == torch.bfloat16),
                      int(k_pages.dtype == torch.bfloat16), pl.dp, pl.split,
                      pl.stages, pl.smem_bytes,
                      torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_flash_attention")
    paged_flash_attention.launches += 1
    return o


paged_flash_attention.launches = 0
