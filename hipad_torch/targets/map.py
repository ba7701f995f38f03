"""Online-map target assignment (counterpart of ``hipad_tpu/targets/map.py``).

GT polylines come with their full permutation set ``[bs, G, perm, pts, 2]``;
the matching cost per (pred, gt) is the min over permutations, and the
winning permutation's points become the regression target.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import matching
from .det import focal_cls_cost, scatter_rows

LINE_COST_WEIGHT = 10.0
SMOOTH_L1_BETA = 0.01


def normalize_line(line: torch.Tensor, roi_size) -> torch.Tensor:
    """ROI-frame ``[..., pts, 2]`` coordinates -> (0, 1)."""
    origin = torch.tensor([-roi_size[0] / 2, -roi_size[1] / 2], dtype=line.dtype,
                          device=line.device)
    norm = torch.tensor([roi_size[0] + 1e-5, roi_size[1] + 1e-5], dtype=line.dtype,
                        device=line.device)
    return (line - origin) / norm


def _smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def map_cost(cls_pred, pts_pred, gt_labels, gt_pts, roi_size):
    """-> (cost [bs, G, P], perm_idx [bs, P, G])."""
    bs, P = cls_pred.shape[:2]
    G, n_perm, n_pts, _ = gt_pts.shape[1:]
    pred_n = normalize_line(pts_pred.reshape(bs, P, n_pts, 2), roi_size)
    gt_n = normalize_line(gt_pts, roi_size)
    diff = pred_n[:, :, None, None] - gt_n[:, None]  # [bs, P, G, perm, pts, 2]
    dist = _smooth_l1(diff, SMOOTH_L1_BETA).sum(dim=(-1, -2)) / n_pts
    perm_idx = dist.argmin(dim=-1)  # first minimum on ties, as jnp.argmin
    reg_cost = torch.gather(dist, -1, perm_idx[..., None])[..., 0]
    cost = focal_cls_cost(cls_pred, gt_labels, 1.0) + reg_cost.transpose(1, 2) * LINE_COST_WEIGHT
    return cost, perm_idx


def map_target(cls_pred, pts_pred, gt_labels, gt_pts, gt_mask, num_cls: int, roi_size,
               col4gt: Optional[torch.Tensor] = None,
               perm_idx: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """-> (cls_target [bs, P] int, pts_target [bs, P, pts*2] (best
    permutation), reg_weights [bs, P, pts*2] (1 where matched))."""
    bs, P = cls_pred.shape[:2]
    G, n_perm, n_pts, _ = gt_pts.shape[1:]
    if col4gt is None or perm_idx is None:
        with torch.no_grad():
            cost, perm_idx = map_cost(cls_pred, pts_pred, gt_labels, gt_pts, roi_size)
            if col4gt is None:
                col4gt = matching.assign(cost, gt_mask)
    col = col4gt.long()
    bidx = torch.arange(bs, device=col.device)[:, None]
    gidx = torch.arange(G, device=col.device)[None, :]
    best_perm = perm_idx[bidx, col.clamp(0, P - 1), gidx]  # [bs, G]
    chosen = gt_pts[bidx, gidx, best_perm].reshape(bs, G, n_pts * 2)
    cls_target = scatter_rows(bs, P, col4gt, gt_labels.long(), num_cls)
    pts_target = scatter_rows(bs, P, col4gt, chosen.to(pts_pred.dtype), 0.0)
    reg_weights = scatter_rows(bs, P, col4gt, torch.ones_like(chosen, dtype=pts_pred.dtype), 0.0)
    return cls_target, pts_target, reg_weights
