"""Launch plans of the dense and weight-only GEMM kernels
(`repro_torch.kernels.gemm_plan`), checked on the CPU: the form, tiles,
k-split and cluster size that the wrappers hand to the CUDA launchers, over
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
