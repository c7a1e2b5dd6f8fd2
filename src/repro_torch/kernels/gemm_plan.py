"""Launch plans of the dense and weight-only GEMMs (`csrc/gemv_cluster.cuh`,
`csrc/gemm_pipe.cuh`).

A plan fixes everything about one launch that depends on the shapes only:
the form (a cluster split-K GEMV for m <= DECODE_MAX_M, a pipelined tile
GEMM above it), the row template or row tile, the column tile, the number
of CTAs of a thread-block cluster that split k (each sums one k-range; the
partials meet in distributed shared memory) and the k values each of them
takes. The wrappers hand the plan to the C launcher, which checks it
against its own instantiations and shared-memory layout, so the choice runs
and is tested on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

SMS = 132                  # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8            # the portable cluster size
MAX_SMEM = 232_448         # bytes of shared memory one CTA may use (227 KB)
DECODE_MAX_M = 16          # m above this takes the tile form
DECODE_THREADS = 256
DECODE_ROWS = (4, 8, 16)   # row templates of the GEMV form (m padded up)
DECODE_BN = (128, 64, 32, 16)
DECODE_MIN_ROWS = 32       # packed weight rows a split takes at least
DECODE_CTAS = 200          # CTAs the split aims for (1.5 an SM)
DECODE_UNION_FLOATS = 8192  # x staging / in-CTA reduction buffer (32 KB)
TILE_BK = 16               # k depth of one pipelined stage
TILE_STAGES = 3
# (BM, BN) tiles of the prefill form, each thread an 8 x 8 micro-tile
TILE_SHAPES = ((128, 128), (128, 64))
TILE_MIN_KTILES = 4        # k stages a split takes at least
TILE_CTAS = 264            # CTAs the split aims for (two an SM)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    form: str              # "gemv" (cluster split-K) or "tile" (pipelined)
    bm: int                # gemv: row template (m <= bm); tile: row tile
    bn: int                # columns of one CTA's tile
    split: int             # CTAs of one cluster, each over one k-range
    k_per_split: int       # k values of each range (the last may be short)
    threads: int
    smem_bytes: int        # static (gemv) or dynamic (tile) shared memory
    grid: Tuple[int, int]  # (split, column tiles) or (split, row x column tiles)

    @property
    def form_id(self) -> int:
        return 0 if self.form == "gemv" else 1

    def k_ranges(self, n: int) -> List[Tuple[int, int]]:
        """The [lo, hi) k-range of each CTA of a cluster."""
        return [(r * self.k_per_split, min(n, (r + 1) * self.k_per_split))
                for r in range(self.split)]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _raw_bytes(bm: int, bn: int, bits: int, elem: int) -> int:
    """Bytes of one stage of the raw (un-widened) copy ring: bf16 x, and
    bf16 or packed-code weights; f32 operands land in the f32 ring."""
    x_raw = bm * TILE_BK * 2 if elem == 2 else 0
    if bits:
        w_raw = TILE_BK * bits // 8 * bn
    else:
        w_raw = TILE_BK * bn * 2 if elem == 2 else 0
    return x_raw + w_raw


def tile_smem_bytes(bm: int, bn: int, split: int, bits: int,
                    elem: int) -> int:
    """Dynamic shared memory of the tile form: the f32 ring (x k-major with
    4 floats of pad, w row-major), the raw ring, and the split's partial
    tile (overlaid on the rings once the mainloop is done)."""
    ring = TILE_STAGES * TILE_BK * (bm + 4 + bn) * 4
    raw = TILE_STAGES * _raw_bytes(bm, bn, bits, elem)
    part = bm * bn * 4 if split > 1 else 0
    return max(ring + raw, part)


def gemv_smem_bytes(mt: int) -> int:
    """Static shared memory of the GEMV form: the union buffer and the
    CTA's (mt, 128) partial."""
    return DECODE_UNION_FLOATS * 4 + mt * 128 * 4


def _gemv_plan(m: int, n: int, p: int, vpb: int) -> GemmPlan:
    mt = next(r for r in DECODE_ROWS if m <= r)
    rows = n // vpb
    # the widest column tile whose clusters still cover every SM, then the
    # fewest CTAs per cluster that reach the CTA target (measured on the
    # H100 over the serving shapes: wider tiles and shorter clusters win
    # once the card is covered)
    most = max(1, min(MAX_CLUSTER, rows // DECODE_MIN_ROWS))
    bn = next((b for b in DECODE_BN if -(-p // b) * most >= SMS),
              DECODE_BN[-1])
    tiles = -(-p // bn)
    split = max(1, min(most, -(-DECODE_CTAS // tiles)))
    per = -(-rows // split)
    split = -(-rows // per)            # no empty range
    return GemmPlan("gemv", mt, bn, split, per * vpb, DECODE_THREADS,
                    gemv_smem_bytes(mt), (split, tiles))


def _tile_plan(m: int, n: int, p: int, bits: int, elem: int) -> GemmPlan:
    # 128 x 128 tiles where there are enough of them to give two CTAs an SM
    # once k is split, 128 x 64 otherwise; the split then brings the grid up
    # to TILE_CTAS (H100 sweep over the serving shapes at m 77 and 512)
    ktiles = -(-n // TILE_BK)
    most = max(1, min(MAX_CLUSTER, ktiles // TILE_MIN_KTILES))

    def tiles(bm, bn):
        return -(-m // bm) * -(-p // bn)

    bm, bn = (128, 128) if tiles(128, 128) * most >= TILE_CTAS else (128, 64)
    t = tiles(bm, bn)
    if t >= TILE_CTAS * 3 // 4:
        split = 1
    elif t >= SMS * 3 // 4:
        split = min(2, most)
    else:
        split = min(most, -(-TILE_CTAS // t))
    per = -(-ktiles // split)
    split = -(-ktiles // per)
    return GemmPlan("tile", bm, bn, split, per * TILE_BK, bm * bn // 64,
                    tile_smem_bytes(bm, bn, split, bits, elem),
                    (split, t))


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, p: int, bits: int = 0, elem: int = 4) -> GemmPlan:
    """The launch plan of y (m, p) = x (m, n) @ w (n, p).

    bits: width of the packed weight codes (8, 4, 2, 1), 0 for a plain
    weight in x's dtype; elem: bytes of one x element (4 f32, 2 bf16).
    """
    if bits not in (0, 8, 4, 2, 1):
        raise ValueError(f"gemm plan: bits={bits}")
    if elem not in (4, 2):
        raise ValueError(f"gemm plan: element size {elem}")
    vpb = 8 // bits if bits else 1
    if m < 1 or n < 1 or p < 1:
        raise ValueError(f"gemm plan: empty product ({m}, {n}) @ ({n}, {p})")
    if n % vpb:
        raise ValueError(f"gemm plan: n={n} not a multiple of vpb={vpb}")
    if m <= DECODE_MAX_M:
        return _gemv_plan(m, n, p, vpb)
    return _tile_plan(m, n, p, bits, elem)


def describe(pl: GemmPlan) -> str:
    return (f"{pl.form} bm={pl.bm} bn={pl.bn} split={pl.split} "
            f"k/split={pl.k_per_split} ctas={pl.ctas} "
            f"smem={pl.smem_bytes} ({math.ceil(pl.smem_bytes / 1024)} KB)")
