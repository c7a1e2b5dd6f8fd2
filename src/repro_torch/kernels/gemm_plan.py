"""Launch plans of the projection GEMMs (`csrc/gemv_cluster.cuh`,
`csrc/gemm_pipe.cuh`, `csrc/gemm_int8.cuh`).

A plan fixes everything about one launch that depends on the shapes only:
the form (a cluster split-K GEMV for m <= DECODE_MAX_M, a tile GEMM above
it), the row template or row tile, the column tile, the number of CTAs of
a thread-block cluster that split k (each sums one k-range; the partials
meet in distributed shared memory) and the k values each of them takes.
The wrappers hand the plan to the C launcher, which checks it against its
own instantiations and shared-memory layout, so the choice runs and is
tested on the CPU.

`plan` serves `dense_matmul` and `quant_matmul`. `bsr_plan` serves both
block-sparse kernels, `bsr_matmul` (float blocks, bits = 0) and
`bsr_quant_matmul` (codes of 8, 4, 2 or 1 bits), over the same two forms:
a column tile lies inside one block column (it divides the block's bn), k
is the concatenation of that column's listed blocks (nnz * bk logical
values) and the k-split counts their packed rows. A block shape neither
form takes keeps the tiled mainloop of `gemm_tile.cuh` (form "mainloop"):
no GEMV column tile divides bn, or, at prefill, bk is not a multiple of the
16-deep stage or no tile column width divides bn. With `batch` > 1 (the
experts of an MoE layer in one launch, the batch a third grid axis) the
CTA targets count every batch's tiles, and rows that fit 64 take the
64-row tiles.

`w8a8_plan` serves `quant_matmul_w8a8`: at decode an int8 GEMV on the same
rule as `plan` whose k-splits are whole 4-k `__dp4a` words (the cluster's
CTAs also share each row's |x| maximum, so the activation quantization
happens inside the one launch); above it a row-quantize kernel and an int8
tensor-core tile (`mma.sync` m16n8k32, W8A8_BM x W8A8_BN x W8A8_BK stages).
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
# the tiles of a batched launch whose rows fit 64 (an MoE prefill's C rows
# an expert, 60 at 512 tokens): a 128-row tile would compute twice them
TILE_SHORT_SHAPES = ((64, 128), (64, 64))
TILE_MIN_KTILES = 4        # k stages a split takes at least
TILE_CTAS = 264            # CTAs the split aims for (two an SM)
# quant_matmul_w8a8's int8 tensor-core tile: 128 x 128 outputs, 64-k stages
# in a 3-deep cp.async ring, 8 warps of 64 x 32
W8A8_BM, W8A8_BN, W8A8_BK = 128, 128, 64
W8A8_STAGES = 3
W8A8_THREADS = 256
W8A8_MIN_KTILES = 2        # k stages a split takes at least
W8A8_WORD = 4              # k values of one int8 dp4a / mma word


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    form: str              # "gemv" (cluster split-K), "tile" (pipelined) or
                           # "mainloop" (gemm_tile.cuh, block-sparse only)
    bm: int                # gemv: row template (m <= bm); tile: row tile
    bn: int                # columns of one CTA's tile
    split: int             # CTAs of one cluster, each over one k-range
    k_per_split: int       # k values of each range (the last may be short)
    threads: int
    smem_bytes: int        # static (gemv) or dynamic (tile) shared memory
    grid: Tuple[int, int]  # (split, column tiles) or (split, row x column
                           # tiles), per batch (the third grid axis)

    @property
    def form_id(self) -> int:
        return ("gemv", "tile", "mainloop").index(self.form)

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


def w8a8_gemv_smem_bytes(mt: int) -> int:
    """Static shared memory of the int8 GEMV: the union buffer (a chunk of
    int8 x words, then the k-lane tree), the CTA's (mt, 128) int32 partial,
    and each row's |x| maximum and scale."""
    return DECODE_UNION_FLOATS * 4 + mt * 128 * 4 + 2 * mt * 4


def w8a8_tile_smem_bytes(split: int) -> int:
    """Dynamic shared memory of the int8 tensor-core tile: per stage the x
    codes (BM rows of BK bytes + 16 of pad) and the raw weight rows (BK x
    BN bytes); one k-major copy of the weight stage (BK / 4 words x BN + 8
    columns); the split's int32 partial tile overlays them."""
    ring = W8A8_STAGES * (W8A8_BM * (W8A8_BK + 16) + W8A8_BK * W8A8_BN)
    wt = W8A8_BK // 4 * (W8A8_BN + 8) * 4
    part = W8A8_BM * W8A8_BN * 4 if split > 1 else 0
    return max(ring + wt, part)


def _gemv_plan(m: int, n: int, p: int, vpb: int,
               widths: Tuple[int, ...] = DECODE_BN,
               align: int = 1, batch: int = 1) -> GemmPlan:
    mt = next(r for r in DECODE_ROWS if m <= r)
    rows = n // vpb
    # the widest column tile whose clusters still cover every SM, then the
    # fewest CTAs per cluster that reach the CTA target (measured on the
    # H100 over the serving shapes: wider tiles and shorter clusters win
    # once the card is covered)
    most = max(1, min(MAX_CLUSTER, rows // DECODE_MIN_ROWS))
    bn = next((b for b in widths if -(-p // b) * most * batch >= SMS),
              widths[-1])
    tiles = -(-p // bn)
    split = max(1, min(most, -(-DECODE_CTAS // (tiles * batch))))
    per = -(-rows // split)
    per = -(-per // align) * align     # whole words of `align` rows
    split = -(-rows // per)            # no empty range
    return GemmPlan("gemv", mt, bn, split, per * vpb, DECODE_THREADS,
                    gemv_smem_bytes(mt), (split, tiles))


def _tile_split(tiles: int, most: int) -> int:
    """CTAs of a cluster that split k over a grid of `tiles` output tiles:
    none once the grid nearly fills TILE_CTAS, two once it nearly covers
    the SMs, else enough to reach TILE_CTAS (at most `most`)."""
    if tiles >= TILE_CTAS * 3 // 4:
        return 1
    if tiles >= SMS * 3 // 4:
        return min(2, most)
    return min(most, -(-TILE_CTAS // tiles))


def _tile_plan(m: int, n: int, p: int, bits: int, elem: int,
               shapes: Tuple[Tuple[int, int], ...] = TILE_SHAPES,
               batch: int = 1) -> GemmPlan:
    # 128 x 128 tiles where there are enough of them to give two CTAs an SM
    # once k is split, 128 x 64 otherwise; the split then brings the grid up
    # to TILE_CTAS (H100 sweep over the serving shapes at m 77 and 512)
    ktiles = -(-n // TILE_BK)
    most = max(1, min(MAX_CLUSTER, ktiles // TILE_MIN_KTILES))

    def tiles(bm, bn):
        return -(-m // bm) * -(-p // bn)

    bm, bn = shapes[0] if len(shapes) == 1 or \
        tiles(*shapes[0]) * most * batch >= TILE_CTAS else shapes[1]
    t = tiles(bm, bn)
    split = _tile_split(t * batch, most)
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


@functools.lru_cache(maxsize=None)
def bsr_plan(m: int, n_pb: int, nnz: int, bk: int, bn: int, bits: int,
             elem: int = 4, batch: int = 1) -> GemmPlan:
    """The launch plan of `bsr_matmul` (bits = 0: float blocks in x's
    dtype) and `bsr_quant_matmul` (codes of `bits` bits): y (m, n_pb * bn)
    from the nnz listed (bk, bn) blocks of each block column; `batch`
    such products in one launch (`bsr_matmul_experts`)."""
    if bits not in (0, 8, 4, 2, 1):
        raise ValueError(f"bsr plan: bits={bits}")
    if elem not in (4, 2):
        raise ValueError(f"bsr plan: element size {elem}")
    vpb = 8 // bits if bits else 1
    if m < 1 or n_pb < 1 or nnz < 1 or bk < 1 or bn < 1 or bk % vpb \
            or batch < 1:
        raise ValueError(f"bsr plan: m={m} n_pb={n_pb} nnz={nnz} bk={bk} "
                         f"bn={bn} bits={bits} batch={batch}")
    n, p = nnz * bk, n_pb * bn
    if m <= DECODE_MAX_M:
        widths = tuple(b for b in DECODE_BN if bn % b == 0)
        if widths:
            return _gemv_plan(m, n, p, vpb, widths, batch=batch)
    else:
        short = batch > 1 and m <= TILE_SHORT_SHAPES[0][0]
        tiles = TILE_SHORT_SHAPES if short else TILE_SHAPES
        shapes = tuple(s for s in tiles if bn % s[1] == 0)
        if shapes and bk % TILE_BK == 0:
            return _tile_plan(m, n, p, bits, elem, shapes, batch=batch)
    # gemm_tile.cuh's own tiles: 16 x 32 at decode rows, 64 x 64 above
    tm, tn = (16, 32) if m <= DECODE_MAX_M else (64, 64)
    return GemmPlan("mainloop", tm, tn, 1, n, 256, 0,
                    (1, -(-m // tm) * n_pb * -(-bn // tn)))


@functools.lru_cache(maxsize=None)
def w8a8_plan(m: int, n: int, p: int) -> GemmPlan:
    """The launch plan of `quant_matmul_w8a8`: y (m, p) from x (m, n),
    quantized per row to int8 inside the launch, and int8 weights (n, p).

    Decode rows take the int8 GEMV, with `plan`'s column tile and split and
    k-splits of whole 4-k words. Prefill rows take the tensor-core tile
    behind one row-quantize kernel; an under-filled grid splits k over a
    cluster (int32 partials, so the order of the sum does not matter)."""
    if m < 1 or n < 1 or p < 1:
        raise ValueError(f"w8a8 plan: empty product ({m}, {n}) @ ({n}, {p})")
    if m <= DECODE_MAX_M:
        pl = _gemv_plan(m, n, p, 1, align=W8A8_WORD)
        return dataclasses.replace(pl, smem_bytes=w8a8_gemv_smem_bytes(pl.bm))
    ktiles = -(-n // W8A8_BK)
    most = max(1, min(MAX_CLUSTER, ktiles // W8A8_MIN_KTILES))
    t = -(-m // W8A8_BM) * -(-p // W8A8_BN)
    split = _tile_split(t, most)
    per = -(-ktiles // split)
    split = -(-ktiles // per)
    return GemmPlan("tile", W8A8_BM, W8A8_BN, split, per * W8A8_BK,
                    W8A8_THREADS, w8a8_tile_smem_bytes(split), (split, t))


def describe(pl: GemmPlan) -> str:
    return (f"{pl.form} bm={pl.bm} bn={pl.bn} split={pl.split} "
            f"k/split={pl.k_per_split} ctas={pl.ctas} "
            f"smem={pl.smem_bytes} ({math.ceil(pl.smem_bytes / 1024)} KB)")
