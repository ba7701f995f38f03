"""Bytes and operations that a sampler call's inputs make it need, and its
least time on the card. Copied from ``chip_smoke.py`` at commit 795f982
(``bound``, ``_tap_ok``, ``_k1_reads``, ``_k2_reads``, ``_k1_reads_coarse``
and the totals its phase 3 adds to them), with the reference's copy of
``_coarse_inputs`` in place of the program's.

Each input byte counts once and each output byte once, whatever a kernel
reads again: the distinct map rows that live taps touch, the points, the
weights, the acc row and the output row. The operations are 2 a channel a
tap (a multiply and an add), in fp32.
"""

from __future__ import annotations

import torch

from ..reference.hipad.ops.sampling import _coarse_inputs
from .peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S


def bound(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: (seconds, "bytes" | "operations")."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _tap_ok(ty, tx, bwd):
    """Whether a tap at hat arguments ``|ty|, |tx|`` is read: the forward
    reads taps whose hat weight is non-zero; the backward also those whose
    weight is zero but whose hat derivative is not (a kink, |t| == 1)."""
    if not bwd:
        return (ty < 1) & (tx < 1)
    return (ty <= 1) & (tx <= 1) & ~((ty == 1) & (tx == 1))


def k1_reads(px, py, wg, h, w, bwd):
    """(taps read, distinct map rows read) by K1 (or K1-bwd) on one level.
    The forward skips (sample, camera) pairs whose group weights are all
    zero; the backward reads every pair in range."""
    B, M = px.shape
    bc = torch.arange(B, device=px.device)[:, None].expand(B, M)
    if bwd:
        ok0 = (px >= -1) & (px <= w) & (py >= -1) & (py <= h)
        offs = (-1, 0, 1)
    else:
        ok0 = (px > -1) & (px < w) & (py > -1) & (py < h) & (wg != 0).any(-1)
        offs = (0, 1)
    x0, y0 = px.clamp(-2, w + 1).floor(), py.clamp(-2, h + 1).floor()
    cells = []
    for dy in offs:
        for dx in offs:
            yy, xx = y0 + dy, x0 + dx
            ok = (ok0 & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                  & _tap_ok((py - yy).abs(), (px - xx).abs(), bwd))
            cells.append(((bc * h + yy.long()) * w + xx.long())[ok])
    cells = torch.cat(cells)
    return cells.numel(), int(torch.unique(cells).numel())


def k2_reads(maps, cam, x, y, w, bwd, lvl=None):
    """(taps read, map bytes read) by K2 (or K2-bwd) over its fine levels,
    or by their level-k variants (``lvl``) over each sample's kept levels."""
    bs, M = x.shape
    cams = maps[0].shape[1]
    bcam = (torch.arange(bs, device=x.device)[:, None] * cams + cam).long()
    valid = (cam >= 0) & (cam < cams)
    taps, nb = 0, 0
    for l, m in enumerate(maps):
        H, W, C = m.shape[2:]
        if lvl is None:
            keep, live = valid, (w[:, :, l] != 0).any(-1)
        else:
            kept = lvl == l
            keep, live = valid & kept.any(-1), (kept & (w != 0).any(-1)).any(-1)
        ok0 = keep if bwd else keep & live
        p, q = x * W - 0.5, y * H - 0.5
        sx, sy = p.floor().clamp(0, W - 2), q.floor().clamp(0, H - 2)
        cells = []
        for i in (0, 1):
            for j in (0, 1):
                ok = ok0 & _tap_ok((q - (sy + i)).abs(), (p - (sx + j)).abs(), bwd)
                cells.append(((bcam * H + (sy + i).long()) * W + (sx + j).long())[ok])
        cells = torch.cat(cells)
        taps += cells.numel()
        nb += int(torch.unique(cells).numel()) * C * m.element_size()
    return taps, nb


def coarse_sample_work(acc, maps, pts, weights, levels):
    """(bytes, operations) of one forward ``coarse_sample`` call: the distinct
    map rows its live taps read over every coarse level, the acc row read
    and the out row written, the points and the coarse levels' weights."""
    xf, yf, _, wf = _coarse_inputs(pts, weights)
    taps, nb = 0, 0
    for lvl, fm in zip(levels, maps):
        h, w, C = fm.shape[2:]
        t, rows = k1_reads(xf * w - 0.5, yf * h - 0.5, wf[:, :, lvl], h, w, bwd=False)
        taps += t
        nb += rows * C * fm.element_size()
    bs, M0, cams, _ = pts.shape
    G, C = weights.shape[-1], maps[0].shape[-1]
    rows_io = (2 if acc is not None else 1) * bs * M0 * C * 4
    nb += rows_io + nbytes(pts) + bs * M0 * cams * len(levels) * G * weights.element_size()
    return nb, taps * C * 2


def patch_sample_work(maps, cam, x, y, w, cam_k, lvl=None):
    """(bytes, operations) of one forward ``patch_sample`` call: the map rows
    its live taps read, its inputs and its ``[bs, M / cam_k, C]`` fp32
    output."""
    taps, map_bytes = k2_reads(maps, cam, x, y, w, False, lvl)
    bs, M = x.shape
    C = maps[0].shape[-1]
    out = bs * (M // cam_k) * C * 4
    return map_bytes + nbytes(cam, x, y, w, lvl) + out, taps * C * 2


