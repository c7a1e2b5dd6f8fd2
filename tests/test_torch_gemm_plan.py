"""Launch plans of the projection GEMM kernels
(`repro_torch.kernels.gemm_plan`: dense, weight-only, both block-sparse
kernels and w8a8), checked on the CPU: the form, tiles, k-split, cluster
size and shared memory that the wrappers hand to the CUDA launchers, over
the serving path's projection shapes."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import gemm_plan as gp

DANUBE = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)]
FALCON = [(4096, 16384), (8192, 288), (8192, 4096)]
NEMOTRON = [(18432, 18432), (18432, 1536), (18432, 73728), (73728, 18432)]
ROWS = [1, 8, 16, 17, 77, 512]
WEIGHTS = [(0, 4), (0, 2), (8, 4), (4, 4), (2, 4), (1, 4), (4, 2)]   # (bits, elem)


@pytest.mark.parametrize("n,p", DANUBE + FALCON + NEMOTRON)
@pytest.mark.parametrize("m", ROWS)
def test_plan_splits_cover_k_in_aligned_pieces(m, n, p):
    for bits, elem in WEIGHTS:
        pl = gp.plan(m, n, p, bits=bits, elem=elem)
        vpb = 8 // bits if bits else 1
        ranges = pl.k_ranges(n)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2                     # no gap, no overlap
        for lo, hi in ranges:
            assert 0 <= lo < hi <= n             # no empty split
            assert lo % vpb == 0 and hi % vpb == 0
            if pl.form == "tile":
                assert lo % gp.TILE_BK == 0
        assert 1 <= pl.split <= gp.MAX_CLUSTER
        assert pl.smem_bytes <= gp.MAX_SMEM
        assert pl.grid[0] == pl.split and pl.grid[1] <= 65535


@pytest.mark.parametrize("m", ROWS)
def test_plan_form_threshold_and_tiles(m):
    for n, p in DANUBE + FALCON:
        pl = gp.plan(m, n, p)
        if m <= gp.DECODE_MAX_M:
            assert pl.form == "gemv" and m <= pl.bm
            assert pl.bm in gp.DECODE_ROWS and pl.bn in gp.DECODE_BN
            assert pl.threads == gp.DECODE_THREADS
            assert pl.grid[1] == -(-p // pl.bn)
        else:
            assert pl.form == "tile"
            assert (pl.bm, pl.bn) in gp.TILE_SHAPES
            assert pl.threads == pl.bm * pl.bn // 64
            assert pl.grid[1] == -(-m // pl.bm) * -(-p // pl.bn)


@pytest.mark.parametrize("n,p", DANUBE + FALCON)
@pytest.mark.parametrize("bits", [0, 8, 4, 2, 1])
def test_decode_form_fills_the_card(n, p, bits):
    """At decode rows every h2o-danube and falcon-mamba projection puts at
    least one CTA on each of the 132 SMs (x_proj's 288 columns included)."""
    for m in (1, 8, 16):
        pl = gp.plan(m, n, p, bits=bits)
        assert pl.form == "gemv"
        assert pl.ctas >= gp.SMS, gp.describe(pl)


def test_shared_memory_matches_the_kernels_layout():
    """The plan's byte counts are the kernels' (the launchers refuse any
    other): GEMV static union + partial; tile rings, raw rings, partial."""
    assert gp.gemv_smem_bytes(16) == 8192 * 4 + 16 * 128 * 4
    # 128 x 128 f32 dense: 3 stages x 16 x (132 + 128) floats
    assert gp.tile_smem_bytes(128, 128, 1, 0, 4) == 3 * 16 * 260 * 4
    # split: the 64 KB partial tile overlays the rings
    assert gp.tile_smem_bytes(128, 128, 2, 0, 4) == 128 * 128 * 4
    # bf16 x and bf16 weight land raw first
    assert gp.tile_smem_bytes(64, 64, 1, 0, 2) == \
        3 * 16 * 132 * 4 + 3 * (64 * 16 * 2 + 16 * 64 * 2)
    # w4 codes: 8 packed rows of 64 bytes a stage
    assert gp.tile_smem_bytes(64, 64, 1, 4, 4) == 3 * 16 * 132 * 4 + 3 * 8 * 64


def test_small_and_ragged_shapes():
    for m, n, p, bits in [(1, 8, 1, 0), (3, 64, 100, 0), (77, 256, 96, 0),
                          (5, 256, 100, 1), (17, 24, 3, 8), (16, 255, 97, 0),
                          (600, 40, 7, 2)]:
        pl = gp.plan(m, n, p, bits=bits)
        ranges = pl.k_ranges(n)
        assert ranges[-1][1] == n and all(lo < hi for lo, hi in ranges)
    with pytest.raises(ValueError):
        gp.plan(4, 12, 8, bits=1)      # n not a multiple of 8 values a byte
    with pytest.raises(ValueError):
        gp.plan(0, 8, 8)
    with pytest.raises(ValueError):
        gp.plan(4, 8, 8, bits=3)


# block-sparse x quantized serving shapes: (n_in, n_out) of h2o-danube and
# falcon-mamba projections on the 128 x 128 block grid, and the test specs
BSR = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560), (4096, 16384),
       (8192, 4096)]
SPARSITIES = [0.5, 0.75]


def _bsr_shapes():
    from repro_torch.core import sparsity as sp
    for n, p in BSR:
        for s in SPARSITIES:
            nnz = sp.nnz_for_sparsity(n // 128, s)
            yield p // 128, nnz, 128, 128
    for bk, bn in [(8, 8), (32, 16), (16, 16), (128, 64), (64, 128)]:
        yield 6, 5, bk, bn


@pytest.mark.parametrize("m", ROWS)
def test_bsr_plan_tiles_divide_the_block_and_splits_cover_listed_rows(m):
    for n_pb, nnz, bk, bn in _bsr_shapes():
        for bits, elem in [(8, 4), (4, 4), (2, 4), (1, 4), (8, 2)]:
            pl = gp.bsr_plan(m, n_pb, nnz, bk, bn, bits, elem)
            if pl.form == "mainloop":
                continue
            vpb = 8 // bits
            rows = nnz * bk // vpb          # packed rows of the listed blocks
            assert bn % pl.bn == 0          # a column tile inside one block
            assert pl.grid[1] == (-(-m // pl.bm) if pl.form == "tile" else 1) \
                * (n_pb * bn // pl.bn)
            owner = [0] * rows              # each listed packed row in one split
            for lo, hi in pl.k_ranges(nnz * bk):
                assert lo % vpb == 0 and hi % vpb == 0 and lo < hi
                for r in range(lo // vpb, hi // vpb):
                    owner[r] += 1
            assert owner == [1] * rows
            assert 1 <= pl.split <= gp.MAX_CLUSTER
            assert pl.ctas <= 65535 * gp.MAX_CLUSTER
            assert pl.smem_bytes <= gp.MAX_SMEM
            if pl.form == "tile":
                # every 16-deep stage inside one listed block
                assert bk % gp.TILE_BK == 0 and pl.k_per_split % gp.TILE_BK == 0
            else:
                assert m <= pl.bm and pl.bm in gp.DECODE_ROWS


# (bk, bn, form at decode rows, form at prefill rows)
BLOCK_FORMS = [
    (128, 128, "gemv", "tile"), (64, 128, "gemv", "tile"),
    (128, 64, "gemv", "tile"), (32, 16, "gemv", "mainloop"),
    (16, 16, "gemv", "mainloop"), (8, 8, "mainloop", "mainloop"),
    (8, 128, "gemv", "mainloop"), (24, 32, "gemv", "mainloop"),
    (4, 4, "mainloop", "mainloop")]


@pytest.mark.parametrize("bk,bn,decode,prefill", BLOCK_FORMS)
def test_bsr_plan_keeps_the_mainloop_exactly_where_the_forms_do_not_fit(
        bk, bn, decode, prefill):
    """The GEMV takes any block with a 16-, 32-, 64- or 128-column tile that
    divides bn; the pipelined tile needs bk % 16 == 0 and a 64- or
    128-column tile that divides bn. Everything else keeps gemm_tile.cuh's
    mainloop, chosen here by shape."""
    for bits in (8, 4, 2, 1):
        if bk % (8 // bits):
            continue
        for m in (1, 8, 16):
            assert gp.bsr_plan(m, 4, 3, bk, bn, bits).form == decode
        for m in (17, 77, 512):
            assert gp.bsr_plan(m, 4, 3, bk, bn, bits).form == prefill


def test_bsr_plan_decode_fills_the_card():
    """s0.5 and s0.75 x w8 at decode rows put at least one CTA on each SM at
    every serving shape: the split counts the listed packed rows only."""
    for n_pb, nnz, bk, bn in list(_bsr_shapes())[:2 * len(BSR)]:
        for m in (1, 8, 16):
            pl = gp.bsr_plan(m, n_pb, nnz, bk, bn, 8)
            assert pl.form == "gemv" and pl.ctas >= gp.SMS, gp.describe(pl)


def test_bsr_plan_refuses_bad_shapes():
    for args in [(0, 4, 3, 128, 128, 8), (4, 4, 3, 12, 16, 1),
                 (4, 4, 0, 128, 128, 8), (4, 4, 3, 128, 128, 3)]:
        with pytest.raises(ValueError):
            gp.bsr_plan(*args)
    with pytest.raises(ValueError):
        gp.bsr_plan(4, 4, 3, 128, 128, 8, elem=8)


# float blocks (`bsr_matmul`, bits = 0) share `bsr_plan` with the quantized
# ones


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("m", ROWS)
def test_bsr_plan_float_blocks_tiles_divide_the_block_and_splits_cover_rows(
        m, elem):
    for n_pb, nnz, bk, bn in _bsr_shapes():
        pl = gp.bsr_plan(m, n_pb, nnz, bk, bn, 0, elem)
        # the same form as the w8 codes of the same blocks
        assert pl.form == gp.bsr_plan(m, n_pb, nnz, bk, bn, 8, elem).form
        if pl.form == "mainloop":
            continue
        rows = nnz * bk                 # listed rows, one k value each
        assert bn % pl.bn == 0          # a column tile inside one block
        owner = [0] * rows
        for lo, hi in pl.k_ranges(rows):
            assert lo < hi
            for r in range(lo, hi):
                owner[r] += 1
        assert owner == [1] * rows
        assert 1 <= pl.split <= gp.MAX_CLUSTER
        if pl.form == "tile":
            assert bk % gp.TILE_BK == 0 and pl.k_per_split % gp.TILE_BK == 0
            assert (pl.bm, pl.bn) in gp.TILE_SHAPES
            assert pl.grid[1] == -(-m // pl.bm) * (n_pb * bn // pl.bn)
            # f32 blocks land in the f32 ring, bf16 ones raw first
            assert pl.smem_bytes == gp.tile_smem_bytes(pl.bm, pl.bn, pl.split,
                                                       0, elem)
        else:
            assert m <= pl.bm and pl.bm in gp.DECODE_ROWS
            assert pl.grid[1] == n_pb * bn // pl.bn
            assert pl.smem_bytes == gp.gemv_smem_bytes(pl.bm)
        assert pl.smem_bytes <= gp.MAX_SMEM


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("bk,bn,decode,prefill", BLOCK_FORMS)
def test_bsr_plan_float_blocks_keep_the_mainloop_exactly_where_the_forms_do_not_fit(
        bk, bn, decode, prefill, elem):
    """The float-block kernel follows the quantized one's rule: the
    gemm_tile.cuh mainloop only where no GEMV column tile divides bn, or
    at prefill where bk % 16 != 0 or no 64/128 tile divides bn."""
    for m in (1, 8, 16):
        assert gp.bsr_plan(m, 4, 3, bk, bn, 0, elem).form == decode
    for m in (17, 77, 512):
        assert gp.bsr_plan(m, 4, 3, bk, bn, 0, elem).form == prefill


@pytest.mark.parametrize("elem", [4, 2])
def test_bsr_plan_float_blocks_decode_fills_the_card(elem):
    """s0.5 and s0.75 float blocks at decode rows put at least one CTA on
    each SM at every serving shape."""
    for n_pb, nnz, bk, bn in list(_bsr_shapes())[:2 * len(BSR)]:
        for m in (1, 8, 16):
            pl = gp.bsr_plan(m, n_pb, nnz, bk, bn, 0, elem)
            assert pl.form == "gemv" and pl.ctas >= gp.SMS, gp.describe(pl)


# quant_matmul_w8a8: the serving shapes, falcon-mamba's x_proj (288 columns),
# and ragged n and p (n not a multiple of 32 or of 4)
W8A8 = DANUBE + FALCON + NEMOTRON + [(255, 97), (200, 100), (520, 288),
                                     (24, 3), (1000, 300)]


@pytest.mark.parametrize("n,p", W8A8)
@pytest.mark.parametrize("m", ROWS)
def test_w8a8_plan_splits_cover_k_in_word_pieces(m, n, p):
    """Each CTA of a cluster takes whole 4-k dp4a words (the last range
    ends at n), the ranges tile k without gap or overlap, and at prefill
    each range is whole 64-k stages."""
    pl = gp.w8a8_plan(m, n, p)
    ranges = pl.k_ranges(n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert 0 <= lo < hi <= n
        assert lo % gp.W8A8_WORD == 0
        assert hi % gp.W8A8_WORD == 0 or hi == n
        if pl.form == "tile":
            assert lo % gp.W8A8_BK == 0
    assert 1 <= pl.split <= gp.MAX_CLUSTER and pl.grid[0] == pl.split
    assert pl.smem_bytes <= gp.MAX_SMEM


@pytest.mark.parametrize("m", ROWS)
def test_w8a8_plan_form_threshold_and_tiles(m):
    for n, p in W8A8:
        pl = gp.w8a8_plan(m, n, p)
        if m <= gp.DECODE_MAX_M:
            assert pl.form == "gemv" and m <= pl.bm
            assert pl.bm in gp.DECODE_ROWS and pl.bn in gp.DECODE_BN
            assert pl.threads == gp.DECODE_THREADS
            assert pl.grid[1] == -(-p // pl.bn)
            assert pl.smem_bytes == gp.w8a8_gemv_smem_bytes(pl.bm)
            # the float GEMV's column tile and cluster rule
            assert pl.bn == gp.plan(m, n, p).bn
        else:
            assert pl.form == "tile"
            assert (pl.bm, pl.bn) == (gp.W8A8_BM, gp.W8A8_BN)
            assert pl.threads == gp.W8A8_THREADS
            assert pl.grid[1] == -(-m // pl.bm) * -(-p // pl.bn)
            assert pl.smem_bytes == gp.w8a8_tile_smem_bytes(pl.split)


@pytest.mark.parametrize("n,p", DANUBE + FALCON)
def test_w8a8_decode_fills_the_card(n, p):
    for m in (1, 8, 16):
        pl = gp.w8a8_plan(m, n, p)
        assert pl.ctas >= gp.SMS, gp.describe(pl)


def test_w8a8_shared_memory_matches_the_kernels_layout():
    """GEMV: the 32 KB union of x words / k-lane tree, the (mt, 128) int32
    partial, each row's maximum and scale. Tile: 3 stages of 128 x (64 + 16)
    code bytes and 64 x 128 raw weight bytes, one k-major copy of 16 words
    x 136 columns, or the 64 KB int32 partial of a split."""
    assert gp.w8a8_gemv_smem_bytes(16) == 8192 * 4 + 16 * 128 * 4 + 2 * 16 * 4
    assert gp.w8a8_gemv_smem_bytes(4) == 8192 * 4 + 4 * 128 * 4 + 2 * 4 * 4
    assert gp.w8a8_tile_smem_bytes(1) == 3 * (128 * 80 + 64 * 128) + 16 * 136 * 4
    assert gp.w8a8_tile_smem_bytes(2) == 128 * 128 * 4
    # falcon-mamba's x_proj at decode: 16-column tiles, a full cluster
    pl = gp.w8a8_plan(8, 8192, 288)
    assert (pl.bn, pl.split, pl.ctas) == (16, 8, 144)
    # an under-filled prefill grid splits k: h2o-danube's k/v projection
    pl = gp.w8a8_plan(512, 2560, 640)
    assert pl.split > 1 and pl.ctas >= gp.SMS


def test_w8a8_plan_refuses_empty_products():
    for args in [(0, 8, 8), (4, 0, 8), (4, 8, 0)]:
        with pytest.raises(ValueError):
            gp.w8a8_plan(*args)
