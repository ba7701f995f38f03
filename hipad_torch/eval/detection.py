"""nuScenes-style 3D detection evaluation (pure numpy).

Compact reimplementation of the vendored evaluator the reference uses
(`datasets/bench2drive_eval_utils.py:8-754` + `bench2drive_dataset.py:
1158-1554`): center-distance matching at thresholds {0.5, 1, 2, 4} m, AP with
min-recall/min-precision clipping, TP errors (ATE/ASE/AOE/AVE) at 2 m, and
the ND score with mean-AP weight 5.

Box convention: decoded [x, y, z, w, l, h, yaw, vx, vy] in the ego/lidar
frame, plus a class name and a score per prediction.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

EVAL_CONFIG = {  # `bench2drive_dataset.py:120-139`
    "dist_ths": [0.5, 1.0, 2.0, 4.0],
    "dist_th_tp": 2.0,
    "min_recall": 0.1,
    "min_precision": 0.1,
    "mean_ap_weight": 5,
    "class_names": ["car", "van", "truck", "bicycle", "traffic_sign",
                    "traffic_cone", "traffic_light", "pedestrian"],
    "tp_metrics": ["trans_err", "scale_err", "orient_err", "vel_err"],
    "class_range": {
        "car": (50, 50), "van": (50, 50), "truck": (50, 50),
        "bicycle": (40, 40), "traffic_sign": (30, 30),
        "traffic_cone": (30, 30), "traffic_light": (30, 30),
        "pedestrian": (40, 40),
    },
}

N_SAMPLE_PTS = 101


def _angle_diff(x, y, period=2 * np.pi):
    d = (x - y + period / 2) % period - period / 2
    return np.abs(d)


def _scale_iou(gt_wlh, pred_wlh) -> float:
    """Size-aligned 3D IoU (`bench2drive_eval_utils.py:79-102`)."""
    mins = np.minimum(gt_wlh, pred_wlh)
    inter = float(np.prod(mins))
    union = float(np.prod(gt_wlh) + np.prod(pred_wlh) - inter)
    return inter / union if union > 0 else 0.0


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (`bench2drive_eval_utils.py:124-137`)."""
    if np.all(np.isnan(x)):
        return np.ones_like(x)
    sum_vals = np.nancumsum(x)
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals > 0)


def accumulate(
    gt_by_frame: List[Dict],
    pred_by_frame: List[Dict],
    class_name: str,
    dist_th: float,
    with_tp: bool,
) -> Dict:
    """Per-class match sweep.

    Each frame dict: {"boxes": [N, 9], "names": [N] str} for GT;
    predictions add "scores": [N].
    """
    npos = sum(int((f["names"] == class_name).sum()) for f in gt_by_frame)
    preds = []
    for fi, f in enumerate(pred_by_frame):
        sel = f["names"] == class_name
        for b, s in zip(f["boxes"][sel], f["scores"][sel]):
            preds.append((s, fi, b))
    if npos == 0 or not preds:
        return None
    preds.sort(key=lambda t: -t[0])

    taken = set()
    tp, fp, conf = [], [], []
    errs = {"trans_err": [], "scale_err": [], "orient_err": [], "vel_err": []}
    for score, fi, box in preds:
        gts = gt_by_frame[fi]
        best_d, best_j = np.inf, None
        for j in np.where(gts["names"] == class_name)[0]:
            if (fi, j) in taken:
                continue
            d = np.linalg.norm(gts["boxes"][j][:2] - box[:2])
            if d < best_d:
                best_d, best_j = d, j
        if best_j is not None and best_d < dist_th:
            taken.add((fi, best_j))
            tp.append(1)
            fp.append(0)
            conf.append(score)
            if with_tp:
                g = gts["boxes"][best_j]
                errs["trans_err"].append(best_d)
                errs["scale_err"].append(1.0 - _scale_iou(g[3:6], box[3:6]))
                period = np.pi if class_name == "barrier" else 2 * np.pi
                errs["orient_err"].append(float(_angle_diff(g[6], box[6], period)))
                errs["vel_err"].append(float(np.linalg.norm(g[7:9] - box[7:9]))
                                       if len(g) > 8 and len(box) > 8 else 0.0)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.array(conf)
    prec = tp / (tp + fp)
    rec = tp / npos
    rec_interp = np.linspace(0, 1, N_SAMPLE_PTS)
    prec = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    out = {"recall": rec_interp, "precision": prec, "confidence": conf_i}
    if with_tp:
        n_tp = int(tp[-1]) if len(tp) else 0
        for k, v in errs.items():
            if n_tp == 0:
                out[k] = np.ones(N_SAMPLE_PTS)
                continue
            # error at each op point, cummean over matches, interp on conf
            arr = _cummean(np.array(v))
            match_conf = conf[np.where(np.diff(np.concatenate([[0], tp])) > 0)]
            out[k] = np.interp(conf_i[::-1], match_conf[::-1], arr[::-1])[::-1]
        out["n_tp"] = n_tp
    return out


def calc_ap(md: Dict, min_recall: float, min_precision: float) -> float:
    prec = md["precision"].copy()
    prec = prec[round(100 * min_recall) + 1 :]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(prec.mean() / (1.0 - min_precision))


def calc_tp(md: Dict, min_recall: float, metric: str) -> float:
    first = round(100 * min_recall) + 1
    # last op point: highest recall achieved
    nonzero = np.nonzero(md["confidence"])[0]
    last = nonzero[-1] if len(nonzero) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[metric][first : last + 1]))


def evaluate_detection(
    gt_by_frame: List[Dict],
    pred_by_frame: List[Dict],
    cfg: Dict = EVAL_CONFIG,
) -> Dict[str, float]:
    """-> {mAP, NDS, mATE, mASE, mAOE, mAVE, per-class APs}."""
    # per-class range filtering (class_range, applied to both GT and preds)
    def filt(frames, is_gt):
        out = []
        for f in frames:
            keep = []
            for i, name in enumerate(f["names"]):
                rng = cfg["class_range"].get(name)
                if rng is None:
                    keep.append(False)
                    continue
                keep.append(
                    abs(f["boxes"][i][0]) <= rng[0] and abs(f["boxes"][i][1]) <= rng[1]
                )
            keep = np.array(keep, bool)
            g = {"boxes": f["boxes"][keep], "names": f["names"][keep]}
            if not is_gt:
                g["scores"] = f["scores"][keep]
            out.append(g)
        return out

    gt = filt(gt_by_frame, True)
    pred = filt(pred_by_frame, False)

    # Classes with no GT anywhere are excluded from the means (on the full
    # val split every configured class is present, so this matches upstream).
    present = [
        c for c in cfg["class_names"]
        if any((f["names"] == c).any() for f in gt)
    ] or list(cfg["class_names"])

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tps: Dict[str, Dict[str, float]] = {}
    for cls in present:
        label_aps[cls] = {}
        for dist_th in cfg["dist_ths"]:
            md = accumulate(gt, pred, cls, dist_th, with_tp=False)
            label_aps[cls][dist_th] = (
                0.0 if md is None else calc_ap(md, cfg["min_recall"], cfg["min_precision"])
            )
        md_tp = accumulate(gt, pred, cls, cfg["dist_th_tp"], with_tp=True)
        label_tps[cls] = {}
        for m in cfg["tp_metrics"]:
            label_tps[cls][m] = 1.0 if md_tp is None else calc_tp(md_tp, cfg["min_recall"], m)

    mean_aps = {c: np.mean(list(v.values())) for c, v in label_aps.items()}
    mAP = float(np.mean(list(mean_aps.values())))
    tp_errors = {m: float(np.mean([label_tps[c][m] for c in present]))
                 for m in cfg["tp_metrics"]}
    # ND score (`bench2drive_eval_utils.py:357-369`)
    tp_scores = {m: max(0.0, 1.0 - v) for m, v in tp_errors.items()}
    total = cfg["mean_ap_weight"] * mAP + sum(tp_scores.values())
    nds = total / (cfg["mean_ap_weight"] + len(tp_scores))

    out = {"mAP": mAP, "NDS": float(nds)}
    name_map = {"trans_err": "mATE", "scale_err": "mASE",
                "orient_err": "mAOE", "vel_err": "mAVE"}
    for m, v in tp_errors.items():
        out[name_map[m]] = v
    for c, v in mean_aps.items():
        out[f"AP_{c}"] = float(v)
    for c in present:
        for m, v in label_tps[c].items():
            out[f"{c}_{m}"] = float(v)
    return out


def format_detection_table(results: Dict[str, float],
                           cfg: Dict = EVAL_CONFIG) -> str:
    """Reference-style report (`bench2drive_dataset.py:1457-1481`):
    headline metrics then a per-class AP/ATE/ASE/AOE/AVE table."""
    lines = ["mAP: %.4f" % results["mAP"]]
    for name in ("mATE", "mASE", "mAOE", "mAVE"):
        if name in results:
            lines.append("%s: %.4f" % (name, results[name]))
    lines += ["NDS: %.4f" % results["NDS"], "", "Per-class results:",
              "Object Class\tAP\tATE\tASE\tAOE\tAVE"]
    for c in cfg["class_names"]:
        if f"AP_{c}" not in results:
            continue
        lines.append("%s\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f" % (
            c, results[f"AP_{c}"],
            results.get(f"{c}_trans_err", float("nan")),
            results.get(f"{c}_scale_err", float("nan")),
            results.get(f"{c}_orient_err", float("nan")),
            results.get(f"{c}_vel_err", float("nan")),
        ))
    return "\n".join(lines)
