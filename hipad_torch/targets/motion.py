"""Motion-forecasting targets (counterpart of ``hipad_tpu/targets/motion.py``):
the det matching's ``col4gt`` scatters agent futures onto anchors, and the
winner-take-all mode per anchor is the one nearest the GT."""

from __future__ import annotations

import torch

from .det import scatter_rows


def motion_target(reg_pred, gt_trajs, gt_trajs_mask, col4gt):
    """reg_pred ``[bs, P, mode, ts, 2]`` offsets; gt ``[bs, G, ts, 2]``, mask
    ``[bs, G, ts]``; col4gt ``[bs, G]`` -> (cls_target [bs, P], cls_weight
    [bs, P] bool, best_reg [bs, P, ts, 2], reg_target [bs, P, ts, 2],
    reg_weight [bs, P, ts], num_pos scalar)."""
    bs, P, mode, ts, _ = reg_pred.shape
    reg_target = scatter_rows(bs, P, col4gt, gt_trajs.to(reg_pred.dtype), 0.0)
    reg_weight = scatter_rows(bs, P, col4gt, gt_trajs_mask.to(reg_pred.dtype), 0.0)
    num_pos = (col4gt >= 0).sum().to(reg_pred.dtype)
    pred_cum = torch.cumsum(reg_pred, dim=-2)
    tgt_cum = torch.cumsum(reg_target, dim=-2)
    dist = torch.linalg.vector_norm(tgt_cum[:, :, None] - pred_cum, dim=-1)  # [bs, P, mode, ts]
    dist = (dist * reg_weight[:, :, None]).mean(dim=-1)
    cls_target = torch.argmin(dist, dim=-1)  # first minimum
    cls_weight = (reg_weight > 0).any(dim=-1)
    idx = cls_target[..., None, None, None].expand(bs, P, 1, ts, 2)
    best_reg = torch.gather(reg_pred, 2, idx).squeeze(2)
    return cls_target, cls_weight, best_reg, reg_target, reg_weight, num_pos
