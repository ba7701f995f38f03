# Frozen copy of hipad_torch/postprocess/det.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Detection and motion post-processing (counterpart of
``hipad_tpu/postprocess/det.py``): batched, with a static top-k, so score
thresholding returns a mask instead of outputs of a data-dependent shape.

Every ranking is ``ops.ranking.topk``: ties go to the lower index, as with
``lax.top_k`` and JAX's stable ``argsort``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.box3d import CNS, decode_box
from ..ops import ranking


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x [bs, P, ...]`` at ``idx [bs, K]`` -> ``[bs, K, ...]``."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def decode_det(
    cls_scores: torch.Tensor,
    box_preds: torch.Tensor,
    instance_id: Optional[torch.Tensor] = None,
    quality: Optional[torch.Tensor] = None,
    num_output: int = 300,
    score_threshold: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Top-k boxes with centerness rescoring. With ``instance_id`` the
    classes are squeezed first (one score per anchor, the tracked path);
    without, the (anchor, class) product is ranked.

    cls_scores ``[bs, P, num_cls]`` last-layer logits; box_preds ``[bs, P,
    11]``; quality ``[bs, P, 2]`` or None -> dict of ``[bs, num_output,
    ...]``: boxes_3d (decoded), scores_3d, labels_3d, cls_scores
    (pre-rescore), anchor_idx, instance_ids, valid.
    """
    prob = torch.sigmoid(cls_scores)
    bs, P, num_cls = prob.shape
    squeeze_cls = instance_id is not None
    num_output = min(num_output, P if squeeze_cls else P * num_cls)

    if squeeze_cls:
        scores, cls_ids = prob.max(dim=-1).values, prob.argmax(dim=-1)
        topv, anchor_idx = ranking.topk(scores, num_output)
        labels = torch.gather(cls_ids, 1, anchor_idx)
    else:
        topv, topi = ranking.topk(prob.reshape(bs, P * num_cls), num_output)
        anchor_idx = topi // num_cls
        labels = topi % num_cls

    scores_origin = topv
    if quality is not None:
        cns = torch.gather(quality[..., CNS], 1, anchor_idx)
        rescored = topv * torch.sigmoid(cns)
        topv, order = ranking.topk(rescored, num_output)  # JAX: a stable argsort(-rescored)
        scores_origin = torch.gather(scores_origin, 1, order)
        anchor_idx = torch.gather(anchor_idx, 1, order)
        labels = torch.gather(labels, 1, order)

    out = {
        "boxes_3d": decode_box(take(box_preds, anchor_idx)),
        "scores_3d": topv,
        "labels_3d": labels.to(torch.int32),
        "cls_scores": scores_origin,
        "anchor_idx": anchor_idx,
    }
    if instance_id is not None:
        out["instance_ids"] = torch.gather(instance_id, 1, anchor_idx)
    out["valid"] = (topv >= score_threshold if score_threshold is not None
                    else torch.ones_like(topv, dtype=torch.bool))
    return out


def decode_motion(det_result: Dict[str, torch.Tensor], motion_cls: torch.Tensor,
                  motion_reg: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per kept detection, the cumulative multi-mode trajectories in the ego
    frame. motion_cls ``[bs, P, mode]`` logits; motion_reg ``[bs, P, mode,
    ts, 2]`` per-step offsets."""
    anchor_idx = det_result["anchor_idx"]
    traj = take(motion_reg, anchor_idx)
    traj_cls = take(torch.sigmoid(motion_cls), anchor_idx)
    traj = torch.cumsum(traj, dim=-2) + det_result["boxes_3d"][:, :, None, None, :2]
    return {"trajs_3d": traj, "trajs_score": traj_cls}
