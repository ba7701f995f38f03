"""Motion-forecasting evaluation: EPA / minADE / minFDE / miss rate.

Compact port of `datasets/evaluation/motion/{motion_eval,motion_utils}.py`
(505 LoC upstream): predictions matched to GT agents by center distance;
matched agents contribute trajectory errors over their valid future steps;
EPA = (hits - 0.5*FP) / num_gt.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

MATCH_DIST = 2.0
MISS_THRESH = 2.0


def evaluate_motion(
    gt_by_frame: List[Dict],
    pred_by_frame: List[Dict],
    class_names=("car", "pedestrian"),
    score_threshold: float = 0.2,
) -> Dict[str, float]:
    """GT frame: {"boxes": [N,>=2] centers, "names": [N], "fut_trajs":
    [N, T, 2] *cumulative* ego-frame futures, "fut_masks": [N, T]}.
    Pred frame: {"boxes": [M,>=2], "names": [M], "scores": [M],
    "trajs": [M, modes, T, 2] cumulative + box center, "traj_scores": [M, modes]}.
    """
    out = {}
    for cls in class_names:
        n_gt = n_hit = n_fp = 0
        ades, fdes, misses = [], [], []
        for g, p in zip(gt_by_frame, pred_by_frame):
            gsel = np.where(g["names"] == cls)[0]
            n_gt += len(gsel)
            psel = np.where((p["names"] == cls) & (p["scores"] >= score_threshold))[0]
            taken = set()
            for pi in sorted(psel, key=lambda i: -p["scores"][i]):
                best_d, best_j = np.inf, None
                for j in gsel:
                    if j in taken:
                        continue
                    d = np.linalg.norm(g["boxes"][j][:2] - p["boxes"][pi][:2])
                    if d < best_d:
                        best_d, best_j = d, j
                if best_j is None or best_d >= MATCH_DIST:
                    n_fp += 1
                    continue
                taken.add(best_j)
                n_hit += 1
                gm = g["fut_masks"][best_j].astype(bool)
                if not gm.any():
                    continue
                gt_traj = g["fut_trajs"][best_j]  # [T, 2] cumulative + center
                trajs = p["trajs"][pi]  # [modes, T, 2]
                err = np.linalg.norm(trajs - gt_traj[None], axis=-1)  # [modes, T]
                valid_err = np.where(gm[None], err, 0.0)
                ade = valid_err.sum(-1) / max(gm.sum(), 1)
                last = int(np.where(gm)[0][-1])
                fde = err[:, last]
                best = int(np.argmin(fde))
                ades.append(float(ade[best]))
                fdes.append(float(fde[best]))
                misses.append(float(fde[best] > MISS_THRESH))
        if n_gt == 0:
            continue
        out[f"{cls}_minADE"] = float(np.mean(ades)) if ades else 0.0
        out[f"{cls}_minFDE"] = float(np.mean(fdes)) if fdes else 0.0
        out[f"{cls}_MR"] = float(np.mean(misses)) if misses else 0.0
        out[f"{cls}_EPA"] = float((n_hit - 0.5 * n_fp) / n_gt)
    return out
