# Frozen copy of hipad_torch/postprocess/map.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Online-map post-processing (counterpart of
``hipad_tpu/postprocess/map.py``): rank the (query, class) product and
return polylines, scores and labels, batched."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import ranking
from .det import take


def decode_map(cls_scores: torch.Tensor, pts_preds: torch.Tensor, coords_dim: int = 2,
               score_threshold: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """cls_scores ``[bs, P, num_cls]`` logits; pts_preds ``[bs, P, pts*2]``."""
    prob = torch.sigmoid(cls_scores)
    bs, P, num_cls = prob.shape
    pts = pts_preds.reshape(bs, P, -1, coords_dim)
    topv, topi = ranking.topk(prob.reshape(bs, P * num_cls), P)
    valid = (topv >= score_threshold if score_threshold is not None
             else torch.ones_like(topv, dtype=torch.bool))
    return {"vectors": take(pts, topi // num_cls), "scores": topv,
            "labels": (topi % num_cls).to(torch.int32), "valid": valid}
