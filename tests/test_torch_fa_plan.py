"""Launch plan of the tensor-core flash attention kernel
(`repro_torch.kernels.flash_attention.fa_plan`), checked on the CPU: the
padded head dim, KV tile and shared memory the wrapper hands to the CUDA
launcher, for every head dim the kernel takes."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa


@pytest.mark.parametrize("elem", [4, 2])
def test_plan_fits_shared_memory_for_every_head_dim(elem):
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        pl = fa.fa_plan(d, elem)
        assert d <= pl.dp and pl.dp in fa.FA_DP
        assert pl.dp % 16 == 0             # whole k16 bf16 / k8 TF32 steps
        assert pl.smem_bytes <= 232_448, (d, elem, pl)
        assert pl.smem_bytes == fa.fa_smem_bytes(pl.dp, pl.bkv, elem)
        assert pl.bkv in fa.FA_BKV and pl.bkv % 16 == 0
        assert pl.bq == 64 and pl.threads == 128 and pl.stages == 2


@pytest.mark.parametrize("elem", [4, 2])
def test_plan_prefers_two_ctas_an_sm(elem):
    """The widest KV tile whose ring lets two CTAs share an SM; the widest
    that fits one only where no tile does (f32 at d = 256)."""
    for dp in fa.FA_DP:
        pl = fa.fa_plan(dp, elem)
        fits2 = [b for b in fa.FA_BKV
                 if fa.fa_smem_bytes(dp, b, elem) <= fa.TWO_CTA_SMEM]
        if fits2:
            assert pl.bkv == fits2[0] and pl.smem_bytes <= fa.TWO_CTA_SMEM
        else:
            assert pl.smem_bytes > fa.TWO_CTA_SMEM
    assert fa.fa_plan(256, 4).bkv == 32
    assert 2 * (fa.TWO_CTA_SMEM + 1024) <= 233_472


def test_plan_of_the_serving_head_dims():
    # smoke (8), h2o-danube (80), nemotron-4-340b (192)
    assert fa.fa_plan(8, 4).dp == 16
    assert fa.fa_plan(80, 4) == fa.FaPlan(80, 64, 64, 2, 107_520, 128)
    assert fa.fa_plan(192, 4) == fa.FaPlan(192, 64, 16, 2, 100_352, 128)
    assert fa.fa_plan(192, 2) == fa.FaPlan(192, 64, 32, 2, 76_800, 128)
    # Q: 64 rows of 80 + 4 floats; K and V: 2 stages of 64 rows each
    assert fa.fa_smem_bytes(80, 64, 4) == (64 + 2 * 2 * 64) * 84 * 4


def test_plan_refuses_what_the_kernel_does_not_take():
    for d, elem in [(0, 4), (257, 4), (64, 8)]:
        with pytest.raises(ValueError):
            fa.fa_plan(d, elem)
