"""K1-bwd's tiling of the map gradient (``kernels.k1_bwd_tiling``) on the
coarse maps the port trains on: 22x40 (level 2 of ``stage2``), 44x80
(level 2 of ``stage2_r101_2x``) and 88x160 (level 1 of ``stage2_r101_2x``,
which ``sampler_matmul_levels=(1, 2, 3)`` sends to K1). The first two fit
one block's shared memory whole; the last, 14,080 cells, is cut into bands
of whole rows. The kernel itself runs only on the card (``chip_smoke.py``
phase 3b holds it on the 88x160 map against autograd of its plain
version)."""

import pytest

from hipad_torch.ops import kernels

BLOCK_SMEM = 232_448  # 227 KB, what one H100 block may opt in to


@pytest.mark.parametrize("hw, ct, s, band", [
    ((22, 40), 32, 4, 22),   # whole map, clusters of 4
    ((44, 80), 16, 1, 44),   # whole map at 16 channels
    ((88, 160), 32, 1, 11),  # 8 bands of 11 rows at 32 channels
])
def test_k1_bwd_tiling_of_the_trained_maps(hw, ct, s, band):
    h, w = hw
    B, C, G = 6, 256, 8  # bs=1, 6 cameras, stage 2's widths
    got_ct, got_s, smem = kernels.k1_bwd_tiling(B, h, w, C, G)
    assert (got_ct, got_s) == (ct, s)
    assert smem % (w * ct * 4) == 0 and smem <= BLOCK_SMEM
    hb = smem // (w * ct * 4)
    assert hb == band
    bands = -(-h // hb)
    # the bands cover every row once, as few as fit, the last no longer
    assert (bands - 1) * hb < h <= bands * hb
    assert (hb + 1) * w * ct * 4 > BLOCK_SMEM or hb == h
