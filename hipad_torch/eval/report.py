"""Reference-style evaluation report tables.

Counterparts of the pretty printers in
`projects/mmdet3d_plugin/datasets/bench2drive_dataset.py:1457-1597` (det
handled by ``detection.format_detection_table``): per-class map AP lines,
the motion PrettyTable (EPA / minADE / minFDE / MR per class) and the STP3
planning grid. Pure-text, no prettytable dependency."""

from __future__ import annotations

from typing import Dict, Sequence

MAP_CLASSES = ("Broken", "Solid", "SolidSolid", "Center")
MOTION_METRICS = ("EPA", "minADE", "minFDE", "MR")


def _grid(field_names: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """Minimal PrettyTable-style ASCII grid."""
    widths = [max(len(str(field_names[i])),
                  *(len(str(r[i])) for r in rows)) if rows else len(str(field_names[i]))
              for i in range(len(field_names))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    def line(vals):
        return "| " + " | ".join(str(v).ljust(w) for v, w in zip(vals, widths)) + " |"
    out = [sep, line(field_names), sep]
    out += [line(r) for r in rows]
    out.append(sep)
    return "\n".join(out)


def format_map_table(results: Dict[str, float],
                     class_names: Sequence[str] = MAP_CLASSES,
                     thresholds: Sequence[float] = (0.5, 1.0, 1.5)) -> str:
    """`bench2drive_dataset.py:1519-1545`: per-threshold header lines, then
    per-class threshold-averaged AP and the overall mAP."""
    lines = ["-*" * 10 + "use metric:chamfer" + "-*" * 10]
    for th in thresholds:
        lines.append("-*" * 10 + f"threshhold:{th}" + "-*" * 10)
    for c in class_names:
        if f"AP_{c}" in results:
            lines.append("{}: {}".format(c, results[f"AP_{c}"]))
    lines.append("map: {}".format(results.get("mAP", 0.0)))
    return "\n".join(lines)


def format_motion_table(results: Dict[str, float],
                        class_names: Sequence[str] = ("car", "pedestrian")) -> str:
    """`bench2drive_dataset.py:1586-1596`: PrettyTable of the four motion
    metrics per class."""
    rows = []
    for c in class_names:
        if f"{c}_EPA" not in results:
            continue
        rows.append([c] + ["%.4f" % results.get(f"{c}_{m}", float("nan"))
                           for m in MOTION_METRICS])
    return _grid(["class names", "EPA", "min_ade_err", "min_fde_err",
                  "miss_rate_err"], rows)


def format_planning_table(results: Dict[str, float]) -> str:
    """STP3-style planning grid: L2 / collision rates at 1/2/3 s + averages
    (counterpart of the planning metric dump in the reference eval hook)."""
    rows = []
    for i in (1, 2, 3):
        rows.append([f"{i}s",
                     "%.4f" % results.get(f"plan_L2_{i}s", float("nan")),
                     "%.4f" % results.get(f"plan_obj_col_{i}s", float("nan")),
                     "%.4f" % results.get(f"plan_obj_box_col_{i}s", float("nan"))])
    if "plan_L2_avg" in results:
        rows.append(["avg", "%.4f" % results["plan_L2_avg"], "-",
                     "%.4f" % results.get("plan_obj_box_col_avg", float("nan"))])
    return _grid(["horizon", "L2 (m)", "obj col", "obj box col"], rows)


def format_summary(summary: Dict[str, Dict[str, float]]) -> str:
    """All available sections of an open-loop eval summary, reference-style."""
    from .detection import format_detection_table

    parts = []
    if "detection" in summary:
        parts.append(format_detection_table(summary["detection"]))
    if "map" in summary:
        parts.append(format_map_table(summary["map"]))
    if "motion" in summary:
        parts.append(format_motion_table(summary["motion"]))
    if "planning" in summary:
        parts.append(format_planning_table(summary["planning"]))
    return "\n\n".join(parts)
