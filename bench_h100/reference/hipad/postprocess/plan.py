# Frozen copy of hipad_torch/postprocess/plan.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Planning post-processing: command and mode selection with the collision
rescore (counterpart of ``hipad_tpu/postprocess/plan.py``), batched: the
low-confidence agents are pushed 1e6 m away instead of filtered out.

As in the JAX package, the ("temp", "2hz") group's cls is collision-rescored
while the mode selection reads the reference group's raw cls, and the ego box
carries no centre offset unless ``center_offset`` asks for one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..core.box3d import COS_YAW, SIN_YAW

EGO_SIZE_B2D = (4.89, 1.84, 1.49)
DIM_SCALE = 1.1
SCORE_THRESH = 0.15
STATIC_DIS_THRESH = 0.5


def get_yaw(traj: torch.Tensor, start_yaw) -> torch.Tensor:
    """Heading along ``traj [..., ts, 2]`` by central differences; a
    trajectory that moves less than 0.5 m keeps ``start_yaw`` (broadcast to
    ``[..., 1]``) at every step -> ``[..., ts]``."""
    start = torch.broadcast_to(torch.as_tensor(start_yaw, dtype=traj.dtype, device=traj.device),
                               traj.shape[:-2] + (1,))
    mid = torch.atan2(traj[..., 2:, 1] - traj[..., :-2, 1], traj[..., 2:, 0] - traj[..., :-2, 0])
    last = torch.atan2(traj[..., -1:, 1] - traj[..., -2:-1, 1],
                       traj[..., -1:, 0] - traj[..., -2:-1, 0])
    yaw = torch.cat([start, mid, last], dim=-1)
    dist = torch.linalg.norm(traj[..., -1, :] - traj[..., 0, :], dim=-1)
    return torch.where((dist < STATIC_DIS_THRESH)[..., None], start, yaw)


def _corners_xy(boxes: torch.Tensor) -> torch.Tensor:
    """The 4 ground-plane corners of ``[..., 7]`` boxes -> ``[..., 4, 2]``."""
    w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    sx = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=boxes.dtype, device=boxes.device)
    sy = torch.tensor([0.5, -0.5, 0.5, -0.5], dtype=boxes.dtype, device=boxes.device)
    cx, cy = w[..., None] * sx, l[..., None] * sy
    cos, sin = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    x = cx * cos - cy * sin + boxes[..., None, 0]
    y = cx * sin + cy * cos + boxes[..., None, 1]
    return torch.stack([x, y], dim=-1)


def _corners_in_box(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """True where any xy-corner of ``boxes2`` lies inside ``boxes1``; the
    shapes broadcast."""
    yaw1 = boxes1[..., 6]
    cos, sin = torch.cos(-yaw1), torch.sin(-yaw1)
    rel = _corners_xy(boxes2) - boxes1[..., None, 0:2]  # [..., 4, 2]
    x = rel[..., 0] * cos[..., None] - rel[..., 1] * sin[..., None]
    y = rel[..., 0] * sin[..., None] + rel[..., 1] * cos[..., None]
    inside = (x.abs() <= boxes1[..., None, 3] / 2) & (y.abs() <= boxes1[..., None, 4] / 2)
    return inside.any(dim=-1)


def check_collision(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Symmetric rough collision test on ``[..., 7]`` boxes."""
    return _corners_in_box(boxes1, boxes2) | _corners_in_box(boxes2, boxes1)


def _cat_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(t[..., :1, :]), t], dim=-2)


def rescore(plan_cls: torch.Tensor, plan_reg: torch.Tensor, motion_cls: torch.Tensor,
            motion_reg: torch.Tensor, det_anchors: torch.Tensor, det_confidence: torch.Tensor,
            center_offset: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add -999 to the cls of every plan mode whose future ego box hits an
    agent's most likely future box; when every mode collides, none is
    penalised.

    plan_cls ``[bs, mode]``; plan_reg ``[bs, mode, ts, 2]`` cumulative
    waypoints; motion_cls ``[bs, P, m_modes]`` sigmoided; motion_reg ``[bs,
    P, m_modes, ts', 2]`` cumulative offsets from each box centre;
    det_anchors ``[bs, P, 11]`` undecoded; det_confidence ``[bs, P]`` ->
    (rescored plan_cls, all_col ``[bs]``, True where every mode collides).
    """
    ts = plan_reg.shape[2]
    ego_traj = _cat_zero(plan_reg)  # [bs, mode, ts+1, 2]
    ego_yaw = get_yaw(ego_traj, math.pi / 2)
    size = torch.tensor(EGO_SIZE_B2D, dtype=plan_reg.dtype, device=plan_reg.device) * DIM_SCALE
    ego_box = torch.cat([ego_traj, torch.zeros_like(ego_traj[..., :1]),
                         size.expand(ego_traj.shape[:-1] + (3,)), ego_yaw[..., None]], dim=-1)

    m_traj = _cat_zero(motion_reg[..., :ts, :]) + det_anchors[:, :, None, None, :2]
    best = motion_cls.argmax(dim=-1)  # [bs, P]
    m_traj = torch.gather(m_traj, 2, best[:, :, None, None, None].expand(
        -1, -1, 1, m_traj.shape[3], 2))[:, :, 0]  # [bs, P, ts+1, 2]
    det_yaw = torch.atan2(det_anchors[..., SIN_YAW], det_anchors[..., COS_YAW])
    m_yaw = get_yaw(m_traj, det_yaw[..., None])
    wlh = torch.exp(det_anchors[..., 3:6])
    m_box = torch.cat([m_traj, torch.zeros_like(m_traj[..., :1]),
                       wlh[:, :, None].expand(m_traj.shape[:-1] + (3,)), m_yaw[..., None]], dim=-1)
    far = torch.zeros_like(m_box)
    far[..., 0:2] = 1e6
    m_box = torch.where((det_confidence < SCORE_THRESH)[..., None, None], far, m_box)

    ego, mot = ego_box[:, :, 1:], m_box[:, :, 1:]  # drop t=0
    if center_offset:
        ego = ego.clone()
        ego[..., 0] += center_offset * torch.cos(ego[..., 6])
        ego[..., 1] += center_offset * torch.sin(ego[..., 6])
    col = check_collision(ego[:, :, None], mot[:, None]).any(dim=3).any(dim=2)  # [bs, mode]
    all_col = col.all(dim=-1)
    col = torch.where(all_col[:, None], torch.zeros_like(col), col)
    return plan_cls + col.to(plan_cls.dtype) * -999.0, all_col


def decode_plan(cfg, plan_out: Dict[str, torch.Tensor], det_out: Optional[Dict],
                motion_out: Optional[Dict], cmd_onehot: torch.Tensor, with_rescore: bool = True,
                rescore_refer: bool = False) -> Dict[str, torch.Tensor]:
    """Split the anchor-type groups, cumsum, select the command, rescore by
    collision, select one mode for all groups by the reference group, and
    select the speed bucket -> ``plan_{kind}_{unit}`` ``[bs, ts, 2]``
    cumulative waypoints and ``plan_mode_idx`` ``[bs]``."""
    cls = plan_out["classification"][-1]  # [bs, 1, N]
    reg = plan_out["prediction"][-1]  # [bs, 1, N, ts, 2]
    bs = cls.shape[0]
    per = cfg.ego_fut_cmd * cfg.ego_fut_mode
    types = cfg.plan_anchor_types
    bidx = torch.arange(bs, device=cls.device)

    cls_g: List[torch.Tensor] = []
    reg_g: List[torch.Tensor] = []
    cmd = cmd_onehot.argmax(dim=-1) if cfg.ego_fut_cmd > 1 else None
    for i in range(len(types)):
        c = cls[:, 0, per * i:per * (i + 1)].reshape(bs, cfg.ego_fut_cmd, -1)
        r = reg[:, 0, per * i:per * (i + 1)].reshape(bs, cfg.ego_fut_cmd, -1, cfg.ego_fut_ts, 2)
        r = torch.cumsum(r, dim=-2)
        if cmd is not None:
            c, r = c[bidx, cmd], r[bidx, cmd]
        else:
            c, r = c[:, 0], r[:, 0]
        cls_g.append(c)  # [bs, mode]
        reg_g.append(r)  # [bs, mode, ts, 2]

    have_agents = det_out is not None and motion_out is not None
    if with_rescore and have_agents:
        det_anchors = det_out["prediction"][-1]
        det_conf = torch.sigmoid(det_out["classification"][-1]).max(dim=-1).values
        motion_cls = torch.sigmoid(motion_out["classification"][-1])
        motion_reg = torch.cumsum(motion_out["prediction"][-1], dim=-2)
        if ("temp", "2hz") in types:
            i = types.index(("temp", "2hz"))
            cls_g[i], _ = rescore(cls_g[i], reg_g[i], motion_cls, motion_reg, det_anchors,
                                  det_conf)
            if rescore_refer:
                cls_g[types.index(cfg.plan_anchor_refer)] = cls_g[i]

    mode_idx = cls_g[types.index(cfg.plan_anchor_refer)].argmax(dim=-1)
    sel_cls = [c[bidx, mode_idx] for c in cls_g]  # each [bs]
    sel_reg = [r[bidx, mode_idx] for r in reg_g]  # each [bs, ts, 2]

    outputs: Dict[str, torch.Tensor] = {"plan_mode_idx": mode_idx}
    speed: Dict[str, Dict] = {}
    for i, t in enumerate(types):
        if t[0] in ("temp", "spat"):
            outputs[f"plan_{t[0]}_{t[1]}"] = sel_reg[i]
        else:
            g = speed.setdefault(t[1], {"cls": [], "reg": []})
            g["cls"].append(sel_cls[i])
            g["reg"].append(sel_reg[i])
    if speed:
        for g in speed.values():
            g["cls"] = torch.stack(g["cls"], dim=1)  # [bs, n_buckets]
            g["reg"] = torch.stack(g["reg"], dim=1)  # [bs, n_buckets, ts, 2]
        if with_rescore and have_agents:
            _rescore_speed(cfg, speed, det_anchors, det_conf, motion_cls, motion_reg)
        for unit, g in speed.items():
            outputs[f"plan_speed_{unit}"] = g["reg"][bidx, g["cls"].argmax(dim=-1)]
    return outputs


def _rescore_speed(cfg, speed, det_anchors, det_conf, motion_cls, motion_reg):
    """One collision pass on the speed-reference frequency; the rescored cls
    is shared by every frequency, and a sample whose buckets all collide has
    its speed trajectories zeroed (a full stop)."""
    unit = cfg.plan_speed_refer[1]
    if unit not in speed:
        return
    reg = speed[unit]["reg"]
    if unit == "5hz":
        # the two ~2 Hz-aligned steps of a 5 Hz trajectory (2, 5) against
        # the first two 2 Hz motion steps; a step past the end reads the
        # last one, as JAX's clamped gather does (only a config with fewer
        # than 6 steps reaches it)
        steps = [min(s, reg.shape[2] - 1) for s in (2, 5)]
        plan_sub, motion_sub = reg[:, :, steps], motion_reg[:, :, :, [0, 1]]
    else:
        plan_sub, motion_sub = reg, motion_reg
    new_cls, all_col = rescore(speed[unit]["cls"], plan_sub, motion_cls, motion_sub,
                               det_anchors, det_conf)
    for u in speed:
        speed[u]["cls"] = new_cls
        speed[u]["reg"] = speed[u]["reg"] * (1.0 - all_col.to(reg.dtype))[:, None, None, None]
