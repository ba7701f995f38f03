"""Online-map evaluation: Chamfer-distance AP (pure numpy, vectorized).

Compact port of `datasets/evaluation/map/{mean_ap,tpfp,tpfp_chamfer}.py`
(585 LoC upstream, multiprocess): per class, predictions matched to GT
polylines when the symmetric Chamfer distance is below a threshold
(0.5 / 1.0 / 1.5 m), AP by score-ranked sweep with 101-point interpolation.

Scale: the upstream parallelizes per-frame chamfer with a worker Pool; here
each (frame, class) computes ONE broadcasted [P, 100, G, 100] distance
tensor -> [P, G] chamfer matrix, reused across all three thresholds, so a
30k-frame val split stays in minutes single-process.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

THRESHOLDS = (0.5, 1.0, 1.5)
N_SAMPLE_PTS = 101


def _resample(line: np.ndarray, num: int = 100) -> np.ndarray:
    seg = np.linalg.norm(np.diff(line, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] < 1e-9:
        return np.tile(line[:1], (num, 1))
    t = np.linspace(0, s[-1], num)
    return np.stack([np.interp(t, s, line[:, 0]), np.interp(t, s, line[:, 1])], axis=1)


def chamfer_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric mean Chamfer distance between two resampled polylines."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return float(0.5 * (d.min(axis=1).mean() + d.min(axis=0).mean()))


def chamfer_matrix(preds: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """[P, K, 2] x [G, K, 2] resampled polylines -> [P, G] symmetric mean
    Chamfer distances (one broadcasted distance tensor, no python loops)."""
    if len(preds) == 0 or len(gts) == 0:
        return np.zeros((len(preds), len(gts)), np.float64)
    # [P, K, G, K]
    d = np.linalg.norm(preds[:, :, None, None] - gts[None, None], axis=-1)
    return 0.5 * (d.min(axis=3).mean(axis=1) + d.min(axis=1).mean(axis=2))


def evaluate_map(
    gt_by_frame: List[Dict],
    pred_by_frame: List[Dict],
    num_classes: int = 4,
    class_names: Sequence[str] = ("Broken", "Solid", "SolidSolid", "Center"),
    thresholds: Sequence[float] = THRESHOLDS,
    score_threshold: float = 0.0,
) -> Dict[str, float]:
    """Each GT frame: {"vectors": [list of [P,2]], "labels": [N]};
    predictions add "scores". -> {mAP, AP_{cls}@{th}, AP_{cls}}."""
    results = {}
    ap_per_class = []
    for cls in range(num_classes):
        # -------- precompute per-frame chamfer matrices (threshold-free)
        npos = 0
        entries = []  # (score, frame_idx, pred_row)
        cham: Dict[int, np.ndarray] = {}
        for fi, (g, p) in enumerate(zip(gt_by_frame, pred_by_frame)):
            gsel = [np.asarray(v) for v, l in zip(g["vectors"], g["labels"])
                    if l == cls]
            npos += len(gsel)
            psel = [(float(s), np.asarray(v)) for v, l, s in
                    zip(p["vectors"], p["labels"], p["scores"])
                    if l == cls and s >= score_threshold]
            if not psel:
                continue
            pr = np.stack([_resample(v) for _, v in psel])
            if gsel:
                gr = np.stack([_resample(v) for v in gsel])
                cham[fi] = chamfer_matrix(pr, gr)
            else:
                cham[fi] = np.zeros((len(psel), 0), np.float64)
            for row, (s, _) in enumerate(psel):
                entries.append((s, fi, row))
        entries.sort(key=lambda t: -t[0])

        aps = []
        for th in thresholds:
            if npos == 0:
                continue
            if not entries:
                aps.append(0.0)
                continue
            taken = set()
            tp, fp = [], []
            for s, fi, row in entries:
                d = cham[fi][row]
                best_d, best_j = np.inf, None
                for j in np.argsort(d):
                    if (fi, j) not in taken:
                        best_d, best_j = d[j], int(j)
                        break
                if best_j is not None and best_d < th:
                    taken.add((fi, best_j))
                    tp.append(1)
                    fp.append(0)
                else:
                    tp.append(0)
                    fp.append(1)
            tp = np.cumsum(tp).astype(float)
            fp = np.cumsum(fp).astype(float)
            rec = tp / npos
            prec = tp / (tp + fp)
            ri = np.linspace(0, 1, N_SAMPLE_PTS)
            pi = np.interp(ri, rec, prec, right=0)
            ap = float(pi.mean())
            aps.append(ap)
            results[f"AP_{class_names[cls]}@{th}"] = ap
        if aps:
            results[f"AP_{class_names[cls]}"] = float(np.mean(aps))
            ap_per_class.append(np.mean(aps))
    results["mAP"] = float(np.mean(ap_per_class)) if ap_per_class else 0.0
    return results
