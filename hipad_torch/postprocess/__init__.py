"""Model outputs -> per-frame results (counterpart of
``hipad_tpu/postprocess/__init__.py``): the batched decode of every task head
runs on the outputs' device (:func:`post_process_arrays`); the per-sample
dicts with the reference's keys are numpy on the host
(:func:`to_result_dicts`)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..utils.spans import span
from .det import decode_det, decode_motion
from .map import decode_map
from .plan import decode_plan

# batched key -> the reference's per-sample key; others keep their name
RESULT_KEYS = {
    "det_boxes_3d": "boxes_3d", "det_scores_3d": "scores_3d",
    "det_labels_3d": "labels_3d", "det_cls_scores": "cls_scores",
    "det_instance_ids": "instance_ids",
    "motion_trajs_3d": "trajs_3d", "motion_trajs_score": "trajs_score",
    "map_vectors": "vectors", "map_scores": "scores", "map_labels": "labels",
}


@span("postprocess")
def post_process_arrays(cfg, outputs: Dict, cmd_onehot: torch.Tensor,
                        with_rescore: bool = True) -> Dict[str, torch.Tensor]:
    """Batched decode of every task head's last layer."""
    res: Dict[str, torch.Tensor] = {}
    det_out = outputs.get("det")
    motion_out = outputs.get("motion")
    if det_out is not None:
        with span("post.det"):
            det_res = decode_det(det_out["classification"][-1], det_out["prediction"][-1],
                                 instance_id=det_out.get("instance_id"),
                                 quality=det_out["quality"][-1], num_output=cfg.det_num_output)
            res.update({f"det_{k}": v for k, v in det_res.items()})
        if motion_out is not None:
            with span("post.motion"):
                mo = decode_motion(det_res, motion_out["classification"][-1],
                                   motion_out["prediction"][-1])
                res.update({f"motion_{k}": v for k, v in mo.items()})
    if "map" in outputs:
        with span("post.map"):
            mp = decode_map(outputs["map"]["classification"][-1],
                            outputs["map"]["prediction"][-1])
            res.update({f"map_{k}": v for k, v in mp.items()})
    if "plan" in outputs:
        with span("post.plan"):
            res.update(decode_plan(cfg, outputs["plan"], det_out, motion_out, cmd_onehot,
                                   with_rescore=with_rescore))
    if "ego" in outputs:
        res["ego_status"] = outputs["ego"]["status"][-1][:, 0]
    return res


@span("to_host")
def to_result_dicts(arrays: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """Split batched arrays into per-sample dicts with the reference's keys."""
    arrays = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
              for k, v in arrays.items()}
    bs = next(iter(arrays.values())).shape[0]
    return [{RESULT_KEYS.get(k, k): v[i] for k, v in arrays.items()} for i in range(bs)]


def post_process(cfg, outputs: Dict, cmd_onehot, with_rescore: bool = True
                 ) -> List[Dict[str, np.ndarray]]:
    device = next(v for head in outputs.values() for v in head.values()).device
    return to_result_dicts(post_process_arrays(
        cfg, outputs, torch.as_tensor(cmd_onehot, device=device), with_rescore))
