"""Auxiliary planning losses (counterpart of ``hipad_tpu/losses/plan_aux.py``):
the reference's three ego-trajectory regularisers, map-boundary proximity,
agent collision and lane-direction consistency. Both shipped configs leave
their weights unset, so ``hipad_loss.PLAN_{BOUND,COL,DIR}_W`` are 0 and
:func:`hipad_loss.loss_plan_aux` runs only when one is set.

Conventions follow the JAX package exactly:
  * ``plan_map_bound_loss`` / ``plan_collision_loss`` take the ego
    trajectory as *cumulative* positions [B, T, 2];
  * ``plan_map_dir_loss`` takes per-step *offsets* and cumsums internally.
Filtered-out elements (low score / wrong class / far away) are moved to 1e6
instead of being dropped; ties of every argmin and argmax go to the lower
index in both packages.
"""

from __future__ import annotations

import math

import torch


def segments_intersect(a_start, a_end, b_start, b_end):
    """Batched 2D segment intersection test; inputs [..., 2] -> bool [...].
    Parallel/coincident pairs count as non-intersecting."""
    d1 = a_end - a_start
    d2 = b_end - b_start
    det = d1[..., 0] * d2[..., 1] - d2[..., 0] * d1[..., 1]
    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    rel = b_start - a_start
    t1 = (rel[..., 0] * d2[..., 1] - rel[..., 1] * d2[..., 0]) / safe_det
    t2 = (rel[..., 0] * d1[..., 1] - rel[..., 1] * d1[..., 0]) / safe_det
    hit = (t1 >= 0) & (t1 <= 1) & (t2 >= 0) & (t2 <= 1)
    return hit & (det != 0)


def _nearest_instance(traj, lanes):
    """The lane instance [B, T, P, 2] nearest each step of ``traj [B, T, 2]``
    (min over its points first) among ``lanes [B, V, P, 2]``."""
    B, T, _ = traj.shape
    V, P = lanes.shape[1:3]
    d_inst = torch.linalg.vector_norm(
        traj[:, :, None, None, :] - lanes[:, None], dim=-1).min(dim=-1).values  # [B, T, V]
    min_inst = torch.argmin(d_inst, dim=-1)  # [B, T]
    idx = min_inst[:, :, None, None, None].expand(B, T, 1, P, 2)
    return torch.gather(lanes[:, None].expand(B, T, V, P, 2), 2, idx)[:, :, 0]


def plan_map_bound_loss(ego_traj, lane_preds, lane_scores, map_thresh: float = 0.5,
                        lane_bound_cls_idx: int = 2, dis_thresh: float = 1.0):
    """Penalty for driving within ``dis_thresh`` of a predicted lane
    boundary, zeroed from the first boundary crossing on. ``ego_traj [B, T,
    2]`` cumulative, ``lane_preds [B, V, P, 2]``, ``lane_scores [B, V, cls]``
    sigmoid scores -> [B, T]."""
    B, T, _ = ego_traj.shape
    V, P = lane_preds.shape[1:3]
    not_bound = lane_scores[..., lane_bound_cls_idx] < map_thresh
    bound = torch.where(not_bound[..., None, None], torch.full_like(lane_preds, 1e6),
                        lane_preds)
    nearest = _nearest_instance(ego_traj, bound)  # [B, T, P, 2]
    starts = torch.cat([torch.zeros_like(ego_traj[:, :1]), ego_traj[:, :-1]], dim=1)
    hit = segments_intersect(starts[:, :, None, :], ego_traj[:, :, None, :],
                             nearest[:, :, :-1, :], nearest[:, :, 1:, :])  # [B, T, P-1]
    crossed = torch.cumsum(hit.any(dim=-1).to(torch.int32), dim=1) > 0
    flat = bound.reshape(B, V * P, 2)
    min_d = torch.linalg.vector_norm(ego_traj[:, :, None, :] - flat[:, None],
                                     dim=-1).min(dim=-1).values  # [B, T]
    zero = torch.zeros_like(min_d)
    loss = torch.where(min_d <= dis_thresh, dis_thresh - min_d, zero)
    return torch.where(crossed, zero, loss)


def plan_collision_loss(ego_traj, agent_pos, agent_scores, agent_fut, agent_fut_cls,
                        agent_thresh: float = 0.5, x_dis_thresh: float = 1.5,
                        y_dis_thresh: float = 3.0, dis_thresh: float = 3.0,
                        vehicle_cls_max: int = 4):
    """Axis-separated proximity penalty to predicted vehicles' best-mode
    futures. ``ego_traj [B, T, 2]``, ``agent_pos [B, A, 2]``, ``agent_scores
    [B, A, cls]``, ``agent_fut [B, A, mode, T, 2]`` cumulative offsets,
    ``agent_fut_cls [B, A, mode]`` -> [B, T, 2] (x loss, y loss)."""
    B, A = agent_pos.shape[:2]
    max_score = agent_scores.max(dim=-1).values
    max_idx = torch.argmax(agent_scores, dim=-1)
    invalid = (max_score < agent_thresh) | (max_idx > vehicle_cls_max)
    best_mode = torch.argmax(agent_fut_cls, dim=-1)  # [B, A]
    T = agent_fut.shape[3]
    fut = torch.gather(agent_fut, 2, best_mode[:, :, None, None, None].expand(B, A, 1, T, 2))
    target = agent_pos[:, :, None, :] + fut[:, :, 0]  # [B, A, T, 2]
    far = torch.full_like(target, 1e6)
    target = torch.where(invalid[:, :, None, None], far, target)
    dist = torch.linalg.vector_norm(ego_traj[:, None] - target, dim=-1)  # [B, A, T]
    target = torch.where(dist[..., None] > dis_thresh, far, target)
    x_min = (ego_traj[:, None, :, 0] - target[..., 0]).abs().min(dim=1).values  # [B, T]
    y_min = (ego_traj[:, None, :, 1] - target[..., 1]).abs().min(dim=1).values
    zero = torch.zeros_like(x_min)
    x_loss = torch.where(x_min <= x_dis_thresh, x_dis_thresh - x_min, zero)
    y_loss = torch.where(y_min <= y_dis_thresh, y_dis_thresh - y_min, zero)
    return torch.stack([x_loss, y_loss], dim=-1)


def plan_map_dir_loss(ego_offsets, lane_preds, lane_scores, map_thresh: float = 0.5,
                      dis_thresh: float = 2.0, lane_div_cls_idx: int = 0):
    """|heading difference| between the ego trajectory and the nearest lane
    divider segment. ``ego_offsets [B, T, 2]`` per-step offsets -> [B, T]."""
    B, T, _ = ego_offsets.shape
    P = lane_preds.shape[2]
    pred = torch.cumsum(ego_offsets, dim=-2)
    static = torch.linalg.vector_norm(pred[:, -1] - pred[:, 0], dim=-1) < 1.0
    not_div = lane_scores[..., lane_div_cls_idx] < map_thresh
    div = torch.where(not_div[..., None, None], torch.full_like(lane_preds, 1e6), lane_preds)
    inst = _nearest_instance(pred, div)  # [B, T, P, 2]
    d_pt = torch.linalg.vector_norm(pred[:, :, None, :] - inst, dim=-1)  # [B, T, P]
    min_pt = torch.argmin(d_pt, dim=-1)  # [B, T]
    nxt = torch.where(min_pt == P - 1, P - 2, min_pt + 1)

    def take_pt(i):
        return torch.gather(inst, 2, i[:, :, None, None].expand(B, T, 1, 2))[:, :, 0]

    p0, p1 = take_pt(min_pt), take_pt(nxt)
    min_d = torch.linalg.vector_norm(p0 - pred, dim=-1)
    dyaw = torch.diff(pred, dim=-2)
    traj_yaw = torch.atan2(dyaw[..., 1], dyaw[..., 0])  # [B, T-1]
    traj_yaw = torch.cat([traj_yaw, traj_yaw[:, -1:]], dim=-1)
    lane_yaw = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    diff = traj_yaw - lane_yaw
    # fold into (-pi/2, pi/2]: a lane's direction is sign-ambiguous
    diff = torch.where(diff > math.pi, diff - math.pi, diff)
    diff = torch.where(diff > math.pi / 2, diff - math.pi, diff)
    diff = torch.where(diff < -math.pi, diff + math.pi, diff)
    diff = torch.where(diff < -math.pi / 2, diff + math.pi, diff)
    zero = torch.zeros_like(diff)
    diff = torch.where(min_d > dis_thresh, zero, diff)
    diff = torch.where(static[:, None], zero, diff)
    return diff.abs()
