"""Regenerate the k-means anchor data assets from a Bench2Drive dataset.

Counterpart of `tools/kmeans/{kmeans_det,kmeans_map,kmeans_motion,
kmeans_plan_spatial,sample_aligned_spatial}.py` (SURVEY §2.8): produces the
five ``.npy`` files under ``data/kmeans/``:

  * det:    900 k-means centers of GT box centers, padded to 11-dim state
            with unit log-size and zero yaw/velocity;
  * map:    100 k-means polyline anchors (20 resampled points);
  * motion: 6 modes per detection class over agent future offsets;
  * plan:   per-command 6x8=48 spatial trajectories at 5 m arc-length
            spacing, resampled to 2 m by arc-length interpolation.

    python -m hipad_torch.tools.kmeans --ann-file data/infos/b2d_infos_train.pkl \
        --map-file data/infos/b2d_map_infos.pkl --out data/kmeans

The port's copy of ``tools/kmeans.py``: its functions are that tool's but
for the two imports, which reach the port's own ``data`` package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means (enough at these sizes; no sklearn dependency)."""
    rng = np.random.RandomState(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    if len(centers) < k:
        centers = np.concatenate(
            [centers, centers[rng.choice(len(centers), k - len(centers))]]
        )
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers


def det_anchors(dataset, num: int = 900, max_frames: int = 5000) -> np.ndarray:
    centers = []
    for i in range(0, len(dataset.data_infos), max(1, len(dataset.data_infos) // max_frames)):
        info = dataset.data_infos[i]
        boxes = info["gt_boxes"]
        if len(boxes):
            centers.append(boxes[:, :3])
    pts = np.concatenate(centers)
    c = kmeans(pts, num)
    anchors = np.zeros((num, 11), np.float32)
    anchors[:, :3] = c
    anchors[:, 7] = 1.0  # cos(yaw)=1; log-sizes zero => unit size
    return anchors


def map_anchors(dataset, num: int = 100, num_pts: int = 20,
                max_frames: int = 2000) -> np.ndarray:
    from ..data.pipelines import interp_polyline

    lines = []
    step = max(1, len(dataset.data_infos) // max_frames)
    for i in range(0, len(dataset.data_infos), step):
        polys, _ = dataset.get_map_polylines(i)
        for pl in polys:
            lines.append(interp_polyline(pl.astype(np.float64), num_pts).reshape(-1))
        if len(lines) > 50000:
            break
    return kmeans(np.stack(lines), num).astype(np.float32).reshape(num, num_pts, 2)


def motion_anchors(dataset, num_classes: int = 9, modes: int = 6, fut_ts: int = 6,
                   max_frames: int = 4000) -> np.ndarray:
    """Per predicted class: k-means modes over agent-frame future offsets."""
    per_class = [[] for _ in range(num_classes)]
    step = max(1, len(dataset.data_infos) // max_frames)
    for i in range(0, len(dataset.data_infos), step):
        info = dataset.data_infos[i]
        trajs, masks = dataset.get_agent_trajs(i, fut_ts, dataset.sample_rate)
        names = info["gt_names"]
        yaws = info["gt_boxes"][:, 6]
        for j, name in enumerate(names):
            if name not in dataset.det_classes or masks[j].sum() < fut_ts:
                continue
            cid = dataset.det_classes.index(name)
            yaw = -(yaws[j] + np.pi / 2)  # remap_box yaw convention
            c, s = np.cos(-yaw), np.sin(-yaw)
            rot = np.array([[c, -s], [s, c]])
            per_class[cid].append((trajs[j] @ rot.T).reshape(-1))
    out = np.zeros((num_classes, modes, fut_ts, 2), np.float32)
    for cid, rows in enumerate(per_class):
        if len(rows) >= modes:
            out[cid] = kmeans(np.stack(rows), modes).reshape(modes, fut_ts, 2)
    return out


def plan_spatial_anchors(dataset, spacing: float, num_cmd: int = 6, modes: int = 8,
                         pts: int = 6, max_frames: int = 20000) -> np.ndarray:
    """Per-command k-means of spatial waypoints -> [num_cmd * modes, pts, 2]."""
    per_cmd = [[] for _ in range(num_cmd)]
    step = max(1, len(dataset.data_infos) // max_frames)
    strategy = dict(mode="uniform", sample_distance=spacing)
    for i in range(0, len(dataset.data_infos), step):
        off, mask = dataset.get_ego_spatial_trajs(i, pts, strategy)
        if mask.sum() < pts:
            continue
        cmd = int(np.argmax(dataset.get_ann_info(i)["gt_ego_fut_cmd"]))
        per_cmd[cmd].append(off.reshape(-1))
    out = []
    for cmd in range(num_cmd):
        rows = per_cmd[cmd]
        if len(rows) >= modes:
            out.append(kmeans(np.stack(rows), modes))
        else:  # fallback: straight-line anchors at this spacing
            base = np.tile(np.array([0.0, spacing]), (pts, 1)).reshape(-1)
            out.append(np.tile(base[None], (modes, 1)))
    return np.concatenate(out).astype(np.float32).reshape(num_cmd * modes, pts, 2)


def resample_spacing(anchors: np.ndarray, src: float, dst: float) -> np.ndarray:
    """5 m anchors -> 2 m via arc-length interpolation
    (`tools/kmeans/sample_aligned_spatial.py:1-21`)."""
    n, pts, _ = anchors.shape
    out = np.zeros_like(anchors)
    for i in range(n):
        wp = np.concatenate([np.zeros((1, 2)), anchors[i].cumsum(0)])
        seg = np.linalg.norm(np.diff(wp, axis=0), axis=1)
        s = np.concatenate([[0], seg.cumsum()])
        t = np.arange(1, pts + 1) * dst
        x = np.interp(t, s, wp[:, 0])
        y = np.interp(t, s, wp[:, 1])
        traj = np.stack([x, y], 1)
        out[i] = np.diff(np.concatenate([np.zeros((1, 2)), traj]), axis=0)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ann-file", required=True)
    p.add_argument("--map-file", default=None)
    p.add_argument("--data-root", default="data/bench2drive")
    p.add_argument("--out", default="data/kmeans")
    args = p.parse_args()

    from ..data.bench2drive import Bench2DriveDataset

    dataset = Bench2DriveDataset(
        ann_file=args.ann_file, map_file=args.map_file, data_root=args.data_root,
        plan_anchor_types=(("spat", "5m"), ("spat", "2m"), ("temp", "2hz")),
    )
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "b2d_det_900.npy"), det_anchors(dataset))
    print("det anchors done")
    np.save(os.path.join(args.out, "b2d_map_100.npy"), map_anchors(dataset))
    print("map anchors done")
    np.save(os.path.join(args.out, "b2d_motion_6.npy"), motion_anchors(dataset))
    print("motion anchors done")
    plan5 = plan_spatial_anchors(dataset, 5.0)
    np.save(os.path.join(args.out, "b2d_plan_spat_6x8_5m.npy"), plan5)
    np.save(os.path.join(args.out, "b2d_plan_spat_6x8_2m.npy"),
            resample_spacing(plan5, 5.0, 2.0))
    print("plan anchors done")


if __name__ == "__main__":
    main()
