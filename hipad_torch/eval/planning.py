"""STP3 open-loop planning metric (pure numpy).

Port of ``PlanningMetric`` (`datasets/evaluation/planning/metric_stp3.py:
15-336`): BEV occupancy on a 0.5 m grid over +-50 m, plan L2, and the two
collision rates (trajectory-point vs. full-ego-box). cv2/skimage polygon
rasterisation is replaced by a numpy convex-fill (identical cells for the
rectangles used here).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

EGO_WIDTH, EGO_LENGTH = 1.85, 4.084  # `metric_stp3.py:13`

X_BOUND = (-50.0, 50.0, 0.5)
Y_BOUND = (-50.0, 50.0, 0.5)

# Obstacle-category sets over the id stored in gt_attr_labels[..., 27],
# which is the *B2D det-class index* (0-8 in DET_CLASS_NAMES order, -1 for
# unknown — `bench2drive_dataset.py:663-665`). The reference's
# `category_index` (`metric_stp3.py:34-37`) still carries nuScenes ids
# (human 2-8, vehicle 14-23) against that field — its vehicle filter can
# never match and its "human" set sweeps in trucks/cones/lights. Here the
# sets name the actual B2D classes: vehicles {car, van, truck, bicycle},
# human {pedestrian}.
VEHICLE_IDS = (0, 1, 2, 3)
HUMAN_IDS = (7,)


def _fill_convex(grid: np.ndarray, corners_rc: np.ndarray):
    """Rasterise a convex polygon given integer (row, col) corners."""
    h, w = grid.shape
    r0 = max(int(corners_rc[:, 0].min()), 0)
    r1 = min(int(corners_rc[:, 0].max()), h - 1)
    c0 = max(int(corners_rc[:, 1].min()), 0)
    c1 = min(int(corners_rc[:, 1].max()), w - 1)
    if r1 < r0 or c1 < c0:
        return
    rr, cc = np.mgrid[r0 : r1 + 1, c0 : c1 + 1]
    pts = np.stack([rr.ravel(), cc.ravel()], axis=1).astype(np.float64)
    inside = np.ones(len(pts), bool)
    n = len(corners_rc)
    sign = 0.0
    for i in range(n):
        a = corners_rc[i]
        b = corners_rc[(i + 1) % n]
        cross = (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (pts[:, 0] - a[0])
        if sign == 0.0:
            s = np.sign(cross[np.abs(cross) > 1e-9])
            sign = s[0] if len(s) else 1.0
        inside &= cross * sign >= -1e-9
    grid[pts[inside, 0].astype(int), pts[inside, 1].astype(int)] = 1


class PlanningMetric:
    def __init__(self):
        self.dx = np.array([X_BOUND[2], Y_BOUND[2]])
        self.bx = np.array([X_BOUND[0] + X_BOUND[2] / 2, Y_BOUND[0] + Y_BOUND[2] / 2])
        self.bev_dimension = np.array(
            [int((X_BOUND[1] - X_BOUND[0]) / X_BOUND[2]),
             int((Y_BOUND[1] - Y_BOUND[0]) / Y_BOUND[2])]
        )
        self.W, self.H = EGO_WIDTH, EGO_LENGTH

    # ---- occupancy --------------------------------------------------------

    def get_label(self, gt_agent_boxes: np.ndarray, gt_agent_feats: np.ndarray):
        """-> (segmentation [1, 6, X, Y], pedestrian [1, 6, X, Y]).

        Args:
          gt_agent_boxes: [N, 9] (x,y,z,w,l,h,yaw,vx,vy) — yaw ALREADY in the
            caller's remapped convention (the caller flips per
            `sparse_head.py:170-173`).
          gt_agent_feats: [N, 34+] attr labels (traj 12, mask 6, goal 1,
            lcf 9, yaw 6).
        """
        T = 6
        seg = np.zeros((T, self.bev_dimension[0], self.bev_dimension[1]))
        ped = np.zeros_like(seg)
        boxes = np.array(gt_agent_boxes, np.float64).copy()
        feats = np.array(gt_agent_feats, np.float64)
        if len(boxes) == 0:
            return seg[None], ped[None]

        trajs = np.cumsum(feats[:, : T * 2].reshape(-1, T, 2), axis=1)
        masks = feats[:, T * 2 : T * 3]
        yaws = np.cumsum(feats[:, T * 3 + 10 : T * 4 + 10].reshape(-1, T, 1), axis=1)
        boxes[:, 6:7] = -(boxes[:, 6:7] + np.pi / 2)  # to lidar yaw
        trajs = trajs + boxes[:, None, 0:2]
        yaws = yaws + boxes[:, None, 6:7]

        bev_start = self.bx - self.dx / 2.0  # = bound mins
        for t in range(T):
            for i in range(len(boxes)):
                if masks[i, t] != 1:
                    continue
                cat = int(feats[i, 27])
                length, width = boxes[i, 4], boxes[i, 3]
                x_a, y_a, yaw_a = trajs[i, t, 0], trajs[i, t, 1], yaws[i, t, 0]
                rot = np.array([[np.cos(yaw_a), -np.sin(yaw_a)],
                                [np.sin(yaw_a), np.cos(yaw_a)]])
                corner = np.array([
                    [length / 2, -length / 2, -length / 2, length / 2],
                    [width / 2, width / 2, -width / 2, -width / 2]])
                lidar = rot @ corner + np.array([[x_a], [y_a]])
                cv = (np.array([[1, 0], [0, -1]]) @ lidar
                      - bev_start[:2, None] + self.dx[:2, None] / 2.0).T / self.dx[:2]
                cv = np.round(cv).astype(np.int32)[:, ::-1]  # (col,row)->(row,col)
                if cat in VEHICLE_IDS:
                    _fill_convex(seg[t], cv)
                if cat in HUMAN_IDS:
                    _fill_convex(ped[t], cv)
        return seg[None], ped[None]

    # ---- collision ----------------------------------------------------------

    def _ego_footprint_cells(self) -> np.ndarray:
        pts = np.array([
            [-self.H / 2.0 + 0.5, self.W / 2.0],
            [self.H / 2.0 + 0.5, self.W / 2.0],
            [self.H / 2.0 + 0.5, -self.W / 2.0],
            [-self.H / 2.0 + 0.5, -self.W / 2.0],
        ])
        pts = (pts - self.bx) / self.dx
        pts[:, [0, 1]] = pts[:, [1, 0]]
        grid = np.zeros(self.bev_dimension, np.uint8)
        corners = np.round(pts[:, ::-1]).astype(np.int32)  # (row, col)
        _fill_convex(grid, corners)
        rr, cc = np.where(grid)
        return np.stack([rr, cc], axis=-1)

    def evaluate_single_coll(self, traj: np.ndarray, segmentation: np.ndarray):
        """traj [T, 2] lidar frame; segmentation [T, X, Y] -> [T] bool."""
        rc = self._ego_footprint_cells()
        T = traj.shape[0]
        trajs = traj[:, None, [1, 0]] / self.dx  # swap to (row-ish, col-ish)
        cells = trajs + rc[None]
        r = (self.bev_dimension[0] - cells[..., 0]).astype(np.int32)
        r = np.clip(r, 0, self.bev_dimension[0] - 1)
        c = np.clip(cells[..., 1].astype(np.int32), 0, self.bev_dimension[1] - 1)
        out = np.zeros(T, bool)
        for t in range(T):
            out[t] = bool(segmentation[t, r[t], c[t]].any())
        return out

    def evaluate_coll(self, trajs: np.ndarray, gt_trajs: np.ndarray,
                      segmentation: np.ndarray):
        """trajs/gt_trajs [B, T, 2]; segmentation [B, T, X, Y] ->
        (obj_coll_sum [T], obj_box_coll_sum [T])."""
        B, T = trajs.shape[:2]
        obj = np.zeros(T)
        box = np.zeros(T)
        for i in range(B):
            gt_coll = self.evaluate_single_coll(gt_trajs[i], segmentation[i])
            xx, yy = trajs[i, :, 0], trajs[i, :, 1]
            xi = ((-self.bx[0] / 2 - yy) / self.dx[0]).astype(np.int64)
            yi = ((-self.bx[1] / 2 + xx) / self.dx[1]).astype(np.int64)
            m1 = ((xi >= 0) & (xi < self.bev_dimension[0])
                  & (yi >= 0) & (yi < self.bev_dimension[1]) & ~gt_coll)
            ti = np.arange(T)
            obj[ti[m1]] += segmentation[i, ti[m1], xi[m1], yi[m1]]
            m2 = ~gt_coll
            pred_coll = self.evaluate_single_coll(trajs[i], segmentation[i])
            box[ti[m2]] += pred_coll[ti[m2]]
        return obj, box

    @staticmethod
    def compute_L2(trajs: np.ndarray, gt_trajs: np.ndarray) -> float:
        d = np.sqrt(((trajs[:, :2] - gt_trajs[:, :2]) ** 2).sum(-1))
        return float(d.mean())


def compute_planner_metric_stp3(
    metric: PlanningMetric,
    pred_ego_fut_trajs: np.ndarray,  # [T, 2] cumulative
    gt_ego_fut_trajs: np.ndarray,  # [T, 2] cumulative
    gt_agent_boxes: np.ndarray,
    gt_agent_feats: np.ndarray,
    fut_valid_flag: bool,
) -> Dict[str, float]:
    """Per-frame plan L2 / collision table (`sparse_head.py:164-203`).

    ``gt_agent_boxes`` must already have the lwh swap + yaw flip applied
    (``remap_box``, `sparse_head.py:168-173`).
    """
    out: Dict[str, float] = {"fut_valid_flag": float(fut_valid_flag)}
    seg, ped = metric.get_label(gt_agent_boxes, gt_agent_feats)
    occupancy = np.logical_or(seg, ped).astype(np.float64)
    for i in range(3):
        if fut_valid_flag:
            cur = (i + 1) * 2
            l2 = metric.compute_L2(pred_ego_fut_trajs[:cur], gt_ego_fut_trajs[:cur])
            obj, box = metric.evaluate_coll(
                pred_ego_fut_trajs[None, :cur], gt_ego_fut_trajs[None, :cur],
                occupancy[:, :cur],
            )
            out[f"plan_L2_{i+1}s"] = l2
            out[f"plan_obj_col_{i+1}s"] = float(obj.mean())
            out[f"plan_obj_box_col_{i+1}s"] = float(box.mean())
        else:
            out[f"plan_L2_{i+1}s"] = 0.0
            out[f"plan_obj_col_{i+1}s"] = 0.0
            out[f"plan_obj_box_col_{i+1}s"] = 0.0
    return out


def aggregate_planning_metrics(per_frame: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Average over frames with valid futures (`bench2drive_dataset.py:1609-1635`)."""
    valid = [m for m in per_frame if m.get("fut_valid_flag")]
    n = max(len(valid), 1)
    keys = [k for k in (valid[0] if valid else {}) if k != "fut_valid_flag"]
    out = {k: sum(m[k] for m in valid) / n for k in keys}
    if "plan_L2_1s" in out:
        out["plan_L2_avg"] = np.mean([out[f"plan_L2_{i}s"] for i in (1, 2, 3)])
        out["plan_obj_box_col_avg"] = np.mean(
            [out[f"plan_obj_box_col_{i}s"] for i in (1, 2, 3)]
        )
    return out
