"""The host-side plan of K1-bwd's and K2-bwd's binned scatter
(``kernels.bin_plan``, ``k1_bwd_plan``, ``k2_bwd_plan``) on the maps the
port trains on: K1-bwd's coarse maps 22x40 and 11x20 (``stage2``), 44x80
and 88x160 (``stage2_r101_2x``), at bs=1 and 2; K2-bwd's fine maps 88x160
and 44x80 (``stage2``). The kernels themselves run only on the card
(``chip_smoke.py`` phase 3b holds them against autograd of their plain
versions and against themselves, bit for bit)."""

import pytest

from hipad_torch.ops import kernels

M = 11_700  # the det task's samples at stage 2: 900 anchors x 13 keypoints
M_PLAN = 43_200  # the plan task's: 480 queries x 90 keypoints, a step's largest K1-bwd call
COUNTS_PER_ITEM = 16  # the counts (bins x chunks) a plan allows an item


@pytest.mark.parametrize("B, hw, m, sw, ow, split, nbins", [
    (6, (22, 40), M, 1, 1, 1, 6 * 23 * 40),         # a warp a cell, a bin a column
    (6, (11, 20), M, 1, 1, 4, 6 * 12 * 20),         # ~200 taps a cell: its items over 4 warps
    (12, (22, 40), M, 2, 1, 1, 12 * 23 * 20),       # bs=2: twice the maps, wider bins
    (6, (44, 80), M, 4, 1, 1, 6 * 45 * 20),         # ~13 taps a cell: one warp
    (6, (88, 160), M, 16, 4, 1, 6 * 89 * 10),       # few taps a cell: runs of 4 cells
    (6, (22, 40), M_PLAN, 1, 1, 4, 6 * 23 * 40),    # a step's largest call: ~196 taps a cell
    (6, (11, 20), M_PLAN, 1, 1, 8, 6 * 12 * 20),    # ~785 taps a cell: a whole block's warps
])
def test_k1_bwd_plan_of_the_trained_maps(B, hw, m, sw, ow, split, nbins):
    h, w = hw
    plan = kernels.k1_bwd_plan(B, h, w, m)
    (lvl,) = plan.levels
    assert (lvl.sw, plan.ow, plan.split, plan.nbins) == (sw, ow, split, nbins)
    # bins: top tap rows -1 .. h-1 of every map, a segment of sw columns
    assert (lvl.tb0, lvl.rowbins, lvl.nseg) == (-1, h + 1, -(-w // sw))
    # the narrowest power of two whose counts stay within those of an item
    assert plan.nbins * plan.chunks <= COUNTS_PER_ITEM * plan.items
    narrower = B * (h + 1) * -(-w // (sw // 2)) if sw > 1 else None
    assert narrower is None or narrower * plan.chunks > COUNTS_PER_ITEM * plan.items
    assert plan.chunks == -(-B * m // 512) and plan.items == B * m
    # the cells kernel: split warps for each run of ow cells of every map
    # row, a power of two that divides a block's 8 warps, each at 32 taps
    # or more of the 4 * B * m a cell could get
    assert plan.warps == B * h * -(-w // ow) and 8 % split == 0
    assert split == 1 or 4 * B * m // (B * h * w) >= 32 * split
    assert plan.host_ints() == [plan.nbins, plan.chunks, plan.warps, ow, split, 1,
                                sw, -1, h + 1, 0, 0]


def test_k2_bwd_plan_of_the_trained_maps():
    """Both fine levels in one plan: level 1's bins and warps follow level
    0's; bin rows are the patch origins 0 .. H-2; runs of 4 cells (about 1
    tap a cell on 88x160, 4 on 44x80)."""
    sizes = [(88, 160), (44, 80)]
    plan = kernels.k2_bwd_plan(1, 6, sizes, 2 * M, 2)
    a, b = plan.levels
    assert (plan.ow, plan.split) == (4, 1) and (a.sw, b.sw) == (16, 16)
    assert (a.tb0, a.rowbins, b.rowbins) == (0, 87, 43)
    assert (a.bin0, b.bin0) == (0, 6 * 87 * 10)
    assert plan.nbins == 6 * 87 * 10 + 6 * 43 * 5
    assert (a.warp0, b.warp0, plan.warps) == (0, 6 * 88 * 40, 6 * 88 * 40 + 6 * 44 * 20)
    assert plan.items == 2 * M * 2 and plan.chunks == -(-plan.items // 512)
    assert plan.nbins * plan.chunks <= COUNTS_PER_ITEM * plan.items
    # the level-k variant: one level slot a sample, the same bins
    lk = kernels.k2_bwd_plan(1, 6, sizes, 2 * M, 1)
    assert lk.levels == plan.levels and lk.items == 2 * M


def test_k2_bwd_plan_of_a_training_steps_largest_call():
    """A stage-2 step's largest K2-bwd call, the plan task's 86,400 slots
    (43,200 samples at cam_k 2) over both fine levels: at bs=1 (6 maps,
    172,800 items, 338 chunks) bins of 16 columns, at bs=2 (12 maps) of 32.
    The counts grow with the items, as many an item at ten times the items:
    the same bins (their cells now a warp each, at ~8 taps a cell). Where even a whole row's bins pass 16 counts an item (96
    maps), the plan takes whole rows all the same."""
    sizes = [(88, 160), (44, 80)]
    one = kernels.k2_bwd_plan(1, 6, sizes, 2 * M_PLAN, 2)
    assert one.chunks == 338 and one.levels[0].sw == 16 and one.nbins == 6 * (87 * 10 + 43 * 5)
    two = kernels.k2_bwd_plan(2, 6, sizes, 2 * M_PLAN, 2)
    assert two.chunks == 675 and two.levels[0].sw == 32
    assert two.nbins == 12 * (87 * 5 + 43 * 3)
    for plan in (one, two):
        assert plan.nbins * plan.chunks <= COUNTS_PER_ITEM * plan.items
    ten = kernels.k2_bwd_plan(2, 6, sizes, 20 * M_PLAN, 2)
    assert [t.sw for t in ten.levels] == [32, 32] and ten.nbins == two.nbins
    assert ten.chunks == 6750
    many = kernels.k2_bwd_plan(16, 6, sizes, 2 * M_PLAN, 2)
    assert many.levels[0].sw == 256 and many.nbins == 96 * (87 + 43)
    assert many.nbins * many.chunks > COUNTS_PER_ITEM * many.items


def test_bin_plan_refuses_what_no_segment_width_fits():
    """Only indices past an int32 are refused: maps whose bins of a whole
    row each pass 16 counts an item (64 maps of 201 bin rows) take bins of a
    whole row, where the first plans refused them."""
    plan = kernels.bin_plan(64, [(200, 40)], 10_000, 40_000, tb0=-1)
    assert plan.levels[0].sw == 64 and plan.nbins == 64 * 201
    assert plan.nbins * plan.chunks > COUNTS_PER_ITEM * plan.items
    with pytest.raises(ValueError, match="int32"):
        kernels.bin_plan(1, [(2, 2)], 2 ** 31, 4, tb0=0)
