"""The byte and operation counts against hand counts at small shapes."""

import math

import torch

from bench_h100.counts import peaks, taps


def test_bound_picks_the_larger_time():
    t, by = taps.bound(3.35e12, 1.0)
    assert by == "bytes" and math.isclose(t, 1.0)
    t, by = taps.bound(1.0, 2 * peaks.FP32_FLOP_PER_S)
    assert by == "operations" and math.isclose(t, 2.0)


def test_coarse_sample_work_by_hand():
    """One sample, one camera, one 4x4 level of C=8 channels at the centre
    of pixel (1, 1) + (0.5, 0.5): its 4 taps read 4 distinct rows."""
    C, G = 8, 2
    fm = torch.zeros(1, 1, 4, 4, C)  # [bs, cams, H, W, C]
    # x * W - 0.5 = 1.5 -> x = 0.5; y likewise
    pts = torch.tensor([[[[0.5, 0.5]]]])  # [bs, M0, cams, 2]
    w = torch.ones(1, 1, 1, 4, G)  # [bs, M0, cams, L, G]
    nb, ops = taps.coarse_sample_work(None, [fm], pts, w, [2])
    rows = 4 * C * 4  # 4 distinct map rows of C fp32
    out_row = 1 * 1 * C * 4
    inputs = pts.numel() * 4 + 1 * 1 * 1 * 1 * G * 4  # points, this level's weights
    assert nb == rows + out_row + inputs
    assert ops == 4 * C * 2


def test_patch_sample_work_by_hand():
    """One slot on camera 0 of a 2-camera 4x4 level at a pixel's corner
    (t = 0 exactly on one axis reads one row there): 2 live taps."""
    C, G = 8, 2
    maps = [torch.zeros(1, 2, 4, 4, C)]
    cam = torch.zeros(1, 1, dtype=torch.int32)
    x = torch.tensor([[1.5 / 4]])  # p = 1.0: sx = 1, tx = 0 and 1 -> one live column
    y = torch.tensor([[1.75 / 4]])  # q = 1.25: rows 1 and 2 live
    w = torch.ones(1, 1, 1, G)
    nb, ops = taps.patch_sample_work(maps, cam, x, y, w, cam_k=1)
    assert ops == 2 * C * 2
    assert nb == 2 * C * 4 + (4 + 4 + 4 + G * 4) + C * 4


def test_flops_of_a_linear_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    lin = torch.nn.Linear(16, 32).requires_grad_(False)
    with FlopCounterMode(display=False) as fc:
        lin(torch.zeros(5, 16))
    assert fc.get_total_flops() == 2 * 5 * 16 * 32
