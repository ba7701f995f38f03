"""Synthetic frame/batch generation: the port's own copy of
``hipad_tpu/data/synthetic.py`` (same numpy RandomState draws, held to the
original by ``tests/test_torch_port_copies.py``).

Produces batches with exactly the shapes and key conventions the real
Bench2Drive loader emits (`datasets/pipelines/transform.py:106-166` adaptor
keys + the GT keys collected in `projects/configs/hipad_b2d_stage2.py:
516-527`) — but from a seeded RNG, so everything runs without the dataset.

GT is *padded* to fixed capacities with validity masks (TPU static shapes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..configs.model import HiPADConfig

MAX_GT_BOXES = 32
MAX_GT_MAP = 24
NUM_MAP_PERMUTE = 38  # 2 * (20 - 1) orderings (`vectorize.py:180-197`)


def _projection_matrices(cfg: HiPADConfig, rng: np.random.RandomState, bs: int):
    """Plausible lidar->image projections for num_cams surround cameras."""
    h, w = cfg.input_size
    fx = w * 0.8
    mats = np.zeros((bs, cfg.num_cams, 4, 4), np.float32)
    for c in range(cfg.num_cams):
        yaw = 2 * np.pi * c / cfg.num_cams
        rot = np.array(
            [[np.cos(yaw), -np.sin(yaw), 0.0],
             [np.sin(yaw), np.cos(yaw), 0.0],
             [0.0, 0.0, 1.0]], np.float32)
        # lidar -> camera (x right, y down, z forward)
        axes = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
        intr = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
        p = intr @ axes @ rot
        mats[:, c, :3, :3] = p
        mats[:, c, :3, 3] = intr @ np.array([0.2, -1.6, 0.3], np.float32)
        mats[:, c, 3, 3] = 1.0
    return mats


def make_metas(
    cfg: HiPADConfig, bs: int, seed: int = 0, timestamp: float = 0.0,
    ego_xy: Tuple[float, float] = (0.0, 0.0),
) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    h, w = cfg.input_size
    t_global = np.tile(np.eye(4, dtype=np.float32), (bs, 1, 1))
    t_global[:, 0, 3] = ego_xy[0]
    t_global[:, 1, 3] = ego_xy[1]
    t_inv = np.linalg.inv(t_global).astype(np.float32)
    cmd = np.zeros((bs, cfg.num_command), np.float32)
    cmd[:, 1] = 1.0
    return {
        "timestamp": np.full((bs,), timestamp, np.float32),
        "projection_mat": _projection_matrices(cfg, rng, bs),
        "image_wh": np.tile(np.array([w, h], np.float32), (bs, cfg.num_cams, 1)),
        "T_global": t_global,
        "T_global_inv": t_inv,
        "target_point": rng.uniform(-20, 20, (bs, 2)).astype(np.float32),
        "gt_ego_fut_cmd": cmd,
        "focal": np.full((bs, cfg.num_cams), w * 0.8, np.float32),
    }


def make_images(cfg: HiPADConfig, bs: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    h, w = cfg.input_size
    return rng.randn(bs, cfg.num_cams, h, w, 3).astype(np.float32)


def make_gt(cfg: HiPADConfig, bs: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Padded multi-task ground truth with the loss-side key convention."""
    rng = np.random.RandomState(seed + 1)
    g, m = MAX_GT_BOXES, MAX_GT_MAP
    n_valid = rng.randint(3, g, size=bs)
    n_map_valid = rng.randint(1, m, size=bs)

    boxes = np.zeros((bs, g, 9), np.float32)
    boxes[..., 0:2] = rng.uniform(-30, 30, (bs, g, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (bs, g))
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (bs, g, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (bs, g))
    boxes[..., 7:9] = rng.uniform(-3, 3, (bs, g, 2))
    labels = rng.randint(0, cfg.num_det_classes, (bs, g)).astype(np.int32)
    valid = np.arange(g)[None] < n_valid[:, None]

    base = rng.uniform(-15, 15, (bs, m, 1, 2)).astype(np.float32)
    direction = rng.uniform(-1, 1, (bs, m, 1, 2)).astype(np.float32)
    ts_lin = np.linspace(0, 10, cfg.map_num_pts, dtype=np.float32)[None, None, :, None]
    line = base + direction * ts_lin  # [bs, m, pts, 2]
    perms = [np.roll(line, s, axis=2) for s in range(NUM_MAP_PERMUTE // 2)]
    perms += [p[:, :, ::-1] for p in perms]
    map_pts = np.stack(perms, axis=2)  # [bs, m, PERM, pts, 2]
    map_labels = rng.randint(0, cfg.num_map_classes, (bs, m)).astype(np.int32)
    map_valid = np.arange(m)[None] < n_map_valid[:, None]

    fut = rng.randn(bs, g, cfg.fut_ts, 2).astype(np.float32) * 0.5
    fut_mask = (rng.rand(bs, g, cfg.fut_ts) > 0.2).astype(np.float32)
    fut_mask = fut_mask * valid[..., None]

    data: Dict[str, np.ndarray] = {
        "gt_labels_3d": labels,
        "gt_bboxes_3d": boxes,
        "gt_valid": valid,
        "gt_map_labels": map_labels,
        "gt_map_pts": map_pts.astype(np.float32),
        "gt_map_valid": map_valid,
        "gt_agent_fut_trajs": fut,
        "gt_agent_fut_masks": fut_mask,
        "ego_status": rng.randn(bs, cfg.ego_status_dims).astype(np.float32),
        "ego_status_mask": np.ones((bs, cfg.ego_status_dims), np.float32),
    }
    units = {t[1] for t in cfg.plan_anchor_types} | {cfg.plan_speed_refer[1]}
    for unit in units:
        key = "gt_ego_spat" if unit.endswith("m") else "gt_ego_fut"
        data[f"{key}_trajs_{unit}"] = (
            rng.randn(bs, cfg.ego_fut_ts, 2).astype(np.float32) * 0.8
        )
        data[f"{key}_masks_{unit}"] = np.ones((bs, cfg.ego_fut_ts), np.float32)
    return data


def make_batch(cfg: HiPADConfig, bs: int, seed: int = 0) -> Dict:
    """One full training batch: images + metas + GT, all numpy."""
    metas = make_metas(cfg, bs, seed)
    batch = {"images": make_images(cfg, bs, seed), **metas, **make_gt(cfg, bs, seed)}
    return batch
