"""The dense depth head's loss (counterpart of ``dense_depth_loss`` in
``hipad_tpu/models/depth_net.py``): a masked mean absolute error against
projected LiDAR depth, in fp32."""

from __future__ import annotations

import torch

from .common import global_sum


def dense_depth_loss(depth_preds, gt_depths, max_depth: float = 60.0,
                     loss_weight: float = 0.2, group=None) -> torch.Tensor:
    """Masked L1 summed over levels; ``gt <= 0`` marks invalid pixels. The
    count of valid pixels is summed over the processes of ``group``
    (``losses/common.py``)."""
    total = 0.0
    for pred, gt in zip(depth_preds, gt_depths):
        pred = pred.reshape(-1)
        gt = gt.reshape(-1)
        fg = (gt > 0.0) & torch.isfinite(pred)
        zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
        pred = torch.clamp(torch.where(fg, pred, zero), 0.0, max_depth)
        err = (pred - torch.where(fg, gt, zero)).abs().sum()
        n = global_sum(fg.sum(), group) * len(depth_preds)
        total = total + err / torch.clamp(n, min=1.0) * loss_weight
    return total
