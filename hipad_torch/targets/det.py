"""Detection target assignment (counterpart of ``hipad_tpu/targets/det.py``).

Ground truth arrives padded to a fixed capacity with a validity mask. The
Hungarian cost is built on the device; the assignment comes from
``matching`` (host), and the targets are scattered back per anchor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.box3d import encode_box
from . import matching

# Hungarian cost hyper-parameters (the JAX package's, stage2 config).
CLS_COST_WEIGHT = 2.0
BOX_COST_WEIGHT = 0.25
MATCH_REG_WEIGHTS = (2.0,) * 3 + (0.5,) * 3 + (0.0,) * 4
# traffic_cone's per-state reg weight override
CONE_CLASS_ID = 5
CONE_REG_WEIGHTS = (2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0)

FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0
_EPS = 1e-12


def focal_cls_cost(cls_pred: torch.Tensor, gt_labels: torch.Tensor,
                   weight: float = 1.0) -> torch.Tensor:
    """Focal classification cost: cls_pred ``[bs, P, num_cls]`` logits,
    gt_labels ``[bs, G]`` -> ``[bs, G, P]`` (rows = GT)."""
    p = torch.sigmoid(cls_pred)
    neg = -torch.log1p(-p + _EPS) * (1.0 - FOCAL_ALPHA) * p ** FOCAL_GAMMA
    pos = -torch.log(p + _EPS) * FOCAL_ALPHA * (1.0 - p) ** FOCAL_GAMMA
    delta = pos - neg  # [bs, P, num_cls]
    idx = gt_labels.long()[:, None, :].expand(-1, delta.shape[1], -1)
    return torch.gather(delta, 2, idx).transpose(1, 2) * weight


def det_encodings(gt_labels: torch.Tensor, gt_boxes: torch.Tensor):
    """GT box encodings and per-instance reg weights -> (enc [bs, G, D],
    inst_w [bs, G, D]): NaN components weigh 0, traffic cones take their
    class-specific weights."""
    enc_raw = encode_box(gt_boxes)
    D = enc_raw.shape[-1]
    enc = torch.nan_to_num(enc_raw, nan=0.0, posinf=0.0, neginf=0.0)
    nan_w = torch.where(torch.isnan(enc_raw), 0.0, 1.0)
    cone_w = torch.tensor(CONE_REG_WEIGHTS[:D], dtype=torch.float32, device=gt_boxes.device)
    inst_w = torch.where((gt_labels == CONE_CLASS_ID)[..., None], cone_w, nan_w)
    return enc, inst_w


def det_cost(cls_pred, box_pred, gt_labels, gt_boxes) -> torch.Tensor:
    """Hungarian cost ``[bs, G, P]`` (focal class cost + weighted L1 box
    cost)."""
    enc, inst_w = det_encodings(gt_labels, gt_boxes)
    D = enc.shape[-1]
    match_w = torch.tensor(MATCH_REG_WEIGHTS[:D], dtype=torch.float32, device=enc.device)
    diff = (box_pred[:, None, :, :D] - enc[:, :, None, :]).abs()  # [bs, G, P, D]
    box_cost = (diff * inst_w[:, :, None, :] * match_w).sum(-1) * BOX_COST_WEIGHT
    return focal_cls_cost(cls_pred, gt_labels, CLS_COST_WEIGHT) + box_cost


def scatter_rows(bs: int, P: int, col4gt: torch.Tensor, values: torch.Tensor,
                 fill) -> torch.Tensor:
    """``[bs, P, ...]`` filled with ``fill``, row ``col4gt[b, g]`` set to
    ``values[b, g]`` for every matched GT (``col4gt >= 0``; the others land
    in a dropped row ``P``)."""
    safe = torch.where(col4gt >= 0, col4gt.long(), P)
    out = torch.full((bs, P + 1) + values.shape[2:], fill, dtype=values.dtype,
                     device=values.device)
    idx = safe.reshape(safe.shape + (1,) * (values.dim() - 2)).expand(values.shape)
    return out.scatter(1, idx, values)[:, :P]


def det_target(cls_pred, box_pred, gt_labels, gt_boxes, gt_mask, num_cls: int,
               col4gt: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Hungarian-match GT boxes to anchors and scatter the targets ->
    (cls_target [bs, P] int (num_cls unmatched), box_target [bs, P, D],
    reg_weights [bs, P, D], col4gt [bs, G] int (-1 invalid))."""
    bs, P, _ = cls_pred.shape
    if col4gt is None:
        with torch.no_grad():
            col4gt = matching.assign(det_cost(cls_pred, box_pred, gt_labels, gt_boxes),
                                     gt_mask)
    enc, inst_w = det_encodings(gt_labels, gt_boxes)
    cls_target = scatter_rows(bs, P, col4gt, gt_labels.long(), num_cls)
    box_target = scatter_rows(bs, P, col4gt, enc.to(box_pred.dtype), 0.0)
    reg_weights = scatter_rows(bs, P, col4gt, inst_w.to(box_pred.dtype), 0.0)
    return cls_target, box_target, reg_weights, col4gt
