"""The HiP-AD multi-task training loss (counterpart of
``hipad_tpu/losses/hipad_loss.py``).

Per-layer Hungarian targets with focal/L1 losses for det and map, ego-status
L1, the winner-take-all motion loss on the last det matching, and the
multi-granularity plan alignment losses, each summed over decoder layers.
GT comes padded with masks; masked selection is a multiply by the mask.

The Hungarian matchings of all layers of both tasks are solved together by
``targets.matching.assign_many``: on the card in one K3 launch, with nothing
copied to the host and no wait for it (on the CPU, its plain version). The
auxiliary plan regularisers (``losses/plan_aux.py``) weigh 0 in both
shipped configs (``PLAN_BOUND_W``, ``PLAN_COL_W``, ``PLAN_DIR_W``); set one
above 0 to add its loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..core.box3d import CNS, COS_YAW, SIN_YAW, X, YNS
from ..targets import det as det_tgt
from ..targets import map as map_tgt
from ..targets import matching
from ..targets import motion as motion_tgt
from ..targets import plan as plan_tgt
from . import plan_aux
from .depth import dense_depth_loss
from .common import (bce_with_logits, gaussian_focal_loss, global_sum, l1_loss,
                     sigmoid_focal_loss, smooth_l1_loss)

# Loss weights (stage2 config).
DET_CLS_W, DET_BOX_W = 2.0, 0.25
DET_REG_WEIGHTS = (2.0,) * 3 + (1.0,) * 7
MAP_CLS_W, MAP_LINE_W, MAP_LINE_BETA = 1.0, 10.0, 0.01
EGO_STATUS_W = 1.0
PLAN_CLS_W, PLAN_REG_W = 0.5, 1.0
MOTION_CLS_W, MOTION_REG_W = 0.2, 0.2
# Auxiliary plan regularisers: present upstream, unset in both shipped configs.
PLAN_BOUND_W, PLAN_COL_W, PLAN_DIR_W = 0.0, 0.0, 0.0


def _det_map_layer_loss(cls, reg, quality, cls_target, reg_target, reg_weights, cfg,
                        num_cls, reg_w_const, cls_lw, is_det, group=None):
    """Shared det/map per-layer loss body."""
    bs, P = cls.shape[:2]
    matched = ~(reg_target == 0).all(dim=-1)  # [bs, P]
    num_pos = torch.clamp(global_sum(matched.sum().float(), group), min=1.0)
    reg_mask = matched
    if cfg.cls_threshold_to_reg > 0:
        reg_mask = matched & (torch.sigmoid(cls.max(dim=-1).values) > cfg.cls_threshold_to_reg)
    cls_loss = sigmoid_focal_loss(cls.reshape(bs * P, -1), cls_target.reshape(bs * P),
                                  num_cls, avg_factor=num_pos, loss_weight=cls_lw)
    w = reg_weights * torch.tensor(reg_w_const, dtype=reg.dtype, device=reg.device)
    w = w * reg_mask[..., None]
    reg_target = torch.nan_to_num(reg_target)
    out = {}
    if is_det:
        out["loss_box"] = l1_loss(reg, reg_target, weight=w, avg_factor=num_pos,
                                  loss_weight=DET_BOX_W)
        cns = quality[..., CNS]
        yns = torch.sigmoid(quality[..., YNS])
        cns_target = torch.exp(-torch.linalg.vector_norm(
            reg_target[..., X:X + 3] - reg[..., X:X + 3], dim=-1))
        cos_sim = (reg_target[..., SIN_YAW] * reg[..., SIN_YAW]
                   + reg_target[..., COS_YAW] * reg[..., COS_YAW])
        sc = [SIN_YAW, COS_YAW]
        norm = (torch.linalg.vector_norm(reg_target[..., sc], dim=-1)
                * torch.linalg.vector_norm(reg[..., sc], dim=-1))
        yns_target = (cos_sim / torch.clamp(norm, min=1e-8) > 0).to(reg.dtype)
        out["loss_cns"] = bce_with_logits(cns, cns_target, weight=reg_mask, avg_factor=num_pos)
        out["loss_yns"] = gaussian_focal_loss(yns, yns_target, weight=reg_mask,
                                              avg_factor=num_pos)
    else:
        n_pts = cfg.map_num_pts
        pred_n = map_tgt.normalize_line(reg.reshape(bs, P, n_pts, 2), cfg.map_roi_size)
        tgt_n = map_tgt.normalize_line(reg_target.reshape(bs, P, n_pts, 2), cfg.map_roi_size)
        out["loss_line"] = smooth_l1_loss(
            pred_n.reshape(bs, P, -1), tgt_n.reshape(bs, P, -1), beta=MAP_LINE_BETA,
            weight=w, avg_factor=num_pos, loss_weight=MAP_LINE_W) / n_pts
    out["loss_cls"] = cls_loss
    return out


def _det_problem(cfg, det_out: Dict, data: Dict):
    """All layers' det costs stacked ``[L*bs, G, P]`` and their row masks."""
    L = det_out["classification"].shape[0]
    with torch.no_grad():
        cost = torch.cat([det_tgt.det_cost(det_out["classification"][i], det_out["prediction"][i],
                                           data["gt_labels_3d"], data["gt_bboxes_3d"])
                          for i in range(L)])
    return cost, torch.cat([data["gt_valid"]] * L)


def _map_problem(cfg, map_out: Dict, data: Dict):
    """All layers' map costs ``[L*bs, G, P]``, row masks, per-layer perm_idx."""
    L = map_out["classification"].shape[0]
    with torch.no_grad():
        cp = [map_tgt.map_cost(map_out["classification"][i], map_out["prediction"][i],
                               data["gt_map_labels"], data["gt_map_pts"], cfg.map_roi_size)
              for i in range(L)]
    return torch.cat([c for c, _ in cp]), torch.cat([data["gt_map_valid"]] * L), \
        [p for _, p in cp]


def loss_det(cfg, det_out: Dict, data: Dict, col_all: Optional[torch.Tensor] = None,
             group=None):
    """Per-layer det losses and the LAST layer's ``col4gt`` (the motion
    loss's matching). ``col_all [L*bs, G]`` is the layer-stacked assignment,
    solved here when not given."""
    losses = {"det_loss_cls": 0.0, "det_loss_box": 0.0,
              "det_loss_cns": 0.0, "det_loss_yns": 0.0}
    L, bs = det_out["classification"].shape[:2]
    if col_all is None:
        col_all = matching.assign(*_det_problem(cfg, det_out, data))
    D = len(DET_REG_WEIGHTS)
    col4gt = None
    for i in range(L):
        cls_t, box_t, rw, col4gt = det_tgt.det_target(
            det_out["classification"][i], det_out["prediction"][i], data["gt_labels_3d"],
            data["gt_bboxes_3d"], data["gt_valid"], cfg.num_det_classes,
            col4gt=col_all[i * bs:(i + 1) * bs])
        out = _det_map_layer_loss(
            det_out["classification"][i], det_out["prediction"][i][..., :D],
            det_out["quality"][i], cls_t, box_t[..., :D], rw[..., :D], cfg,
            cfg.num_det_classes, DET_REG_WEIGHTS, DET_CLS_W, is_det=True, group=group)
        for k, v in out.items():
            losses["det_" + k] = losses["det_" + k] + v
    return losses, col4gt


def loss_map(cfg, map_out: Dict, data: Dict, col_all: Optional[torch.Tensor] = None,
             perm_idx: Optional[Sequence[torch.Tensor]] = None, group=None):
    losses = {"map_loss_cls": 0.0, "map_loss_line": 0.0}
    L, bs = map_out["classification"].shape[:2]
    if col_all is None or perm_idx is None:
        cost, mask, perm_idx = _map_problem(cfg, map_out, data)
        col_all = matching.assign(cost, mask)
    for i in range(L):
        cls, reg = map_out["classification"][i], map_out["prediction"][i]
        cls_t, pts_t, rw = map_tgt.map_target(
            cls, reg, data["gt_map_labels"], data["gt_map_pts"], data["gt_map_valid"],
            cfg.num_map_classes, cfg.map_roi_size, col4gt=col_all[i * bs:(i + 1) * bs],
            perm_idx=perm_idx[i])
        out = _det_map_layer_loss(cls, reg, None, cls_t, pts_t, rw, cfg, cfg.num_map_classes,
                                  (1.0,) * (cfg.map_num_pts * 2), MAP_CLS_W, is_det=False,
                                  group=group)
        for k, v in out.items():
            losses["map_" + k] = losses["map_" + k] + v
    return losses


def loss_ego(cfg, ego_out: Dict, data: Dict, group=None):
    total = 0.0
    for i in range(ego_out["status"].shape[0]):
        status = ego_out["status"][i].squeeze(1)  # [bs, 6]
        sl = l1_loss(status, data["ego_status"], weight=data["ego_status_mask"],
                     loss_weight=EGO_STATUS_W, group=group)
        total = total + torch.nan_to_num(sl)
    return {"ego_loss_status": total}


def loss_motion(cfg, motion_out: Dict, data: Dict, col4gt, group=None):
    losses = {"motion_loss_cls": 0.0, "motion_loss_reg": 0.0}
    for i in range(motion_out["classification"].shape[0]):
        cls = motion_out["classification"][i]  # [bs, P, mode]
        reg = motion_out["prediction"][i]  # [bs, P, mode, ts, 2]
        cls_t, cls_w, best_reg, reg_t, reg_w, num_pos = motion_tgt.motion_target(
            reg, data["gt_agent_fut_trajs"], data["gt_agent_fut_masks"], col4gt)
        num_pos = torch.clamp(global_sum(num_pos, group), min=1.0)
        bs, P = cls.shape[:2]
        closs = sigmoid_focal_loss(cls.reshape(bs * P, -1), cls_t.reshape(bs * P),
                                   cfg.fut_mode, weight=cls_w.reshape(bs * P).to(cls.dtype),
                                   avg_factor=num_pos, loss_weight=MOTION_CLS_W)
        rloss = l1_loss(torch.cumsum(best_reg, dim=-2), torch.cumsum(reg_t, dim=-2),
                        weight=reg_w[..., None], avg_factor=num_pos, loss_weight=MOTION_REG_W)
        losses["motion_loss_cls"] = losses["motion_loss_cls"] + closs
        losses["motion_loss_reg"] = losses["motion_loss_reg"] + rloss
    return losses


def _plan_gt(cfg, data: Dict, anchor_type):
    kind, unit = anchor_type[0], anchor_type[1]
    key = "gt_ego_spat" if kind == "spat" else "gt_ego_fut"
    return data[f"{key}_trajs_{unit}"], data[f"{key}_masks_{unit}"]


def _plan_pred(cfg, cls, reg, anchor_type):
    """One anchor type's block: cls [bs,1,N], reg [bs,1,N,ts,2]."""
    per = cfg.ego_fut_cmd * cfg.ego_fut_mode
    i = cfg.plan_anchor_types.index(anchor_type)
    return cls[:, :, per * i:per * (i + 1)], reg[:, :, per * i:per * (i + 1)]


def _align_loss_pair(cfg, cls, cls_target, cls_weight, reg_pred, reg_target, reg_weight,
                     group=None):
    bs = cls.shape[0]
    closs = sigmoid_focal_loss(cls.reshape(bs, -1), cls_target.reshape(bs), cls.shape[-1],
                               weight=cls_weight.reshape(bs).to(cls.dtype),
                               loss_weight=PLAN_CLS_W, group=group)
    rloss = l1_loss(torch.cumsum(reg_pred, dim=-2), torch.cumsum(reg_target, dim=-2),
                    weight=reg_weight[..., None], loss_weight=PLAN_REG_W, group=group)
    return closs, rloss


def loss_plan(cfg, plan_out: Dict, data: Dict, group=None):
    """Multi-granularity plan loss."""
    cmd = data["gt_ego_fut_cmd"]
    losses: Dict[str, torch.Tensor] = {}
    # the kinds in the config's order (the JAX package iterates a set of
    # strings, whose order, and so the sum of total_loss, follows the hash seed)
    for kind in dict.fromkeys(t[0] for t in cfg.plan_anchor_types):
        losses[f"plan_loss_{kind}_cls"] = 0.0
        losses[f"plan_loss_{kind}_reg"] = 0.0
    for i in range(plan_out["classification"].shape[0]):
        cls = plan_out["classification"][i]  # [bs, 1, N]
        reg = plan_out["prediction"][i]  # [bs, 1, N, ts, 2]
        ref_cls, ref_reg = _plan_pred(cfg, cls, reg, cfg.plan_anchor_refer)
        ref_gt, ref_gm = _plan_gt(cfg, data, cfg.plan_anchor_refer)
        _, ref_target, ref_cls_w, _, _, _ = plan_tgt.sparse_plan_target(
            ref_cls, ref_reg, ref_gt, ref_gm, cmd, cfg.ego_fut_cmd, cfg.ego_fut_ts)
        speed_groups: Dict[str, Dict] = {}
        for t in cfg.plan_anchor_types:
            p_cls, p_reg = _plan_pred(cfg, cls, reg, t)
            gt, gm = _plan_gt(cfg, data, t)
            if t[0] in ("temp", "spat"):
                a_cls, a_tgt, _, a_reg, a_gt, a_gm = plan_tgt.align_plan_target(
                    p_cls, p_reg, gt, gm, cmd, ref_target, cfg.ego_fut_cmd, cfg.ego_fut_ts)
                # the cls loss takes the reference type's GT weight
                closs, rloss = _align_loss_pair(cfg, a_cls, a_tgt, ref_cls_w, a_reg.squeeze(1),
                                                a_gt.squeeze(1), a_gm.squeeze(1), group)
                losses[f"plan_loss_{t[0]}_cls"] = losses[f"plan_loss_{t[0]}_cls"] + closs
                losses[f"plan_loss_{t[0]}_reg"] = losses[f"plan_loss_{t[0]}_reg"] + rloss
            else:  # speed buckets, grouped by frequency
                g = speed_groups.setdefault(t[1], {"cls": [], "reg": [], "gt": gt, "gm": gm,
                                                   "areas": []})
                g["cls"].append(p_cls)
                g["reg"].append(p_reg)
                g["areas"].append(t[2])
        for g in speed_groups.values():
            closs, rloss = _speed_loss(cfg, data, cmd, ref_target, g, group)
            losses["plan_loss_speed_cls"] = losses["plan_loss_speed_cls"] + closs
            losses["plan_loss_speed_reg"] = losses["plan_loss_speed_reg"] + rloss
    return losses


def _speed_loss(cfg, data, cmd, ref_target, speeds, group=None):
    """Per speed bucket of ``speeds`` (one frequency's buckets), the
    reference-aligned mode's cls/reg; the cls target is the GT speed's
    bucket."""
    bs = ref_target.shape[0]
    bidx = torch.arange(bs, device=ref_target.device)
    aligned_cls, aligned_reg = [], []
    for p_cls, p_reg in zip(speeds["cls"], speeds["reg"]):
        a_cls, _, _, a_reg, _, _ = plan_tgt.align_plan_target(
            p_cls, p_reg, speeds["gt"], speeds["gm"], cmd, ref_target, cfg.ego_fut_cmd,
            cfg.ego_fut_ts)
        aligned_cls.append(a_cls.squeeze(1)[bidx, ref_target.squeeze(-1)][:, None, None])
        aligned_reg.append(a_reg[:, :, None])  # [bs, 1, 1, ts, 2]
    cls_pred = torch.cat(aligned_cls, dim=-1)  # [bs, 1, n_buckets]
    reg_pred = torch.cat(aligned_reg, dim=-3)  # [bs, 1, n_buckets, ts, 2]

    ref_speed_gt, ref_speed_gm = _plan_gt(cfg, data, cfg.plan_speed_refer)
    ref_speed_gt, ref_speed_gm = ref_speed_gt[:, None], ref_speed_gm[:, None]
    dist = torch.linalg.vector_norm(ref_speed_gt, dim=-1).sum(-1)
    interval = 1.0 / float(cfg.plan_speed_refer[1].split("hz")[0])
    gt_speed = dist / (ref_speed_gm.sum(-1) * interval + 1e-4)
    mode_idx = torch.ones_like(gt_speed, dtype=torch.long)
    for si, (start, end) in enumerate(speeds["areas"]):
        mode_idx = torch.where((gt_speed >= start) & (gt_speed < end), si, mode_idx)
    cls_weight = (ref_speed_gm > 0).any(dim=-1)
    idx = mode_idx[..., None, None, None].expand(mode_idx.shape + (1, cfg.ego_fut_ts, 2))
    best_reg = torch.gather(reg_pred, 2, idx).squeeze(2)
    gt, gm = speeds["gt"][:, None], speeds["gm"][:, None]
    closs = sigmoid_focal_loss(cls_pred.reshape(bs, -1), mode_idx.reshape(bs),
                               cls_pred.shape[-1], weight=cls_weight.reshape(bs).to(cls_pred.dtype),
                               loss_weight=PLAN_CLS_W, group=group)
    rloss = l1_loss(torch.cumsum(best_reg, dim=-2), torch.cumsum(gt, dim=-2),
                    weight=gm[..., None], loss_weight=PLAN_REG_W, group=group)
    return closs, rloss


def compute_losses(cfg, outputs: Dict, data: Dict,
                   depth_preds: Optional[Sequence[torch.Tensor]] = None,
                   group=None) -> Dict[str, torch.Tensor]:
    """Every task loss the config turns on. The det and map matchings of all
    layers are solved together, in one ``assign_many`` call (det's columns
    first). ``group`` (a
    ``torch.distributed`` process group, or None) makes each loss this
    process's share of the loss of the group's global batch
    (``losses/common.py``)."""
    losses: Dict[str, torch.Tensor] = {}
    problems, perm_idx = [], None
    if "det" in cfg.task_select:
        problems.append(_det_problem(cfg, outputs["det"], data))
    if "map" in cfg.task_select:
        cost, mask, perm_idx = _map_problem(cfg, outputs["map"], data)
        problems.append((cost, mask))
    cols = iter(matching.assign_many(problems)) if problems else iter(())
    col4gt = None
    if "det" in cfg.task_select:
        det_losses, col4gt = loss_det(cfg, outputs["det"], data, next(cols), group)
        losses.update(det_losses)
    if "map" in cfg.task_select:
        losses.update(loss_map(cfg, outputs["map"], data, next(cols), perm_idx, group))
    if "ego" in cfg.task_select and cfg.with_supervise_ego_status:
        losses.update(loss_ego(cfg, outputs["ego"], data, group))
    if "motion" in cfg.task_select and col4gt is not None:
        losses.update(loss_motion(cfg, outputs["motion"], data, col4gt, group))
    if "plan" in cfg.task_select:
        losses.update(loss_plan(cfg, outputs["plan"], data, group))
        if PLAN_BOUND_W > 0 or PLAN_COL_W > 0 or PLAN_DIR_W > 0:
            losses.update(loss_plan_aux(cfg, outputs, data, group))
    if depth_preds is not None:
        gt_depth = data.get("gt_depth") or [data[f"gt_depth_{i}"] for i in range(len(depth_preds))
                                             if f"gt_depth_{i}" in data]
        if gt_depth:
            losses["depth_loss"] = dense_depth_loss(depth_preds, gt_depth, group=group)
    return losses


def loss_plan_aux(cfg, outputs: Dict, data: Dict, group=None) -> Dict[str, torch.Tensor]:
    """The map-boundary, collision and lane-direction regularisers on the
    reference anchor type's GT-selected mode, last layer only."""
    cmd = data["gt_ego_fut_cmd"]
    cls = outputs["plan"]["classification"][-1]
    reg = outputs["plan"]["prediction"][-1]
    ref_cls, ref_reg = _plan_pred(cfg, cls, reg, cfg.plan_anchor_refer)
    gt, gm = _plan_gt(cfg, data, cfg.plan_anchor_refer)
    _, _, cls_w, best_reg, _, _ = plan_tgt.sparse_plan_target(
        ref_cls, ref_reg, gt, gm, cmd, cfg.ego_fut_cmd, cfg.ego_fut_ts)
    offsets = best_reg.reshape(best_reg.shape[0], cfg.ego_fut_ts, 2)
    ego_traj = torch.cumsum(offsets, dim=-2)
    w = cls_w.reshape(-1, 1).to(offsets.dtype)
    norm = global_sum(w.sum(), group) * cfg.ego_fut_ts

    out: Dict[str, torch.Tensor] = {}
    if PLAN_BOUND_W > 0 or PLAN_DIR_W > 0:
        lane = outputs["map"]["prediction"][-1]
        lane = lane.reshape(lane.shape[0], lane.shape[1], cfg.map_num_pts, 2)
        lane_scores = torch.sigmoid(outputs["map"]["classification"][-1])
        if PLAN_BOUND_W > 0:
            lb = plan_aux.plan_map_bound_loss(ego_traj, lane, lane_scores)
            out["plan_loss_bound"] = PLAN_BOUND_W * (lb * w).sum() / (norm + 1e-6)
        if PLAN_DIR_W > 0:
            ld = plan_aux.plan_map_dir_loss(offsets, lane, lane_scores)
            out["plan_loss_dir"] = PLAN_DIR_W * (ld * w).sum() / (norm + 1e-6)
    if PLAN_COL_W > 0 and "motion" in cfg.task_select:
        det = outputs["det"]["prediction"][-1]
        det_scores = torch.sigmoid(outputs["det"]["classification"][-1])
        mot_reg = outputs["motion"]["prediction"][-1]
        mot_cls = outputs["motion"]["classification"][-1]
        lc = plan_aux.plan_collision_loss(ego_traj, det[..., :2], det_scores,
                                          torch.cumsum(mot_reg, dim=-2), mot_cls)
        out["plan_loss_col"] = PLAN_COL_W * (lc * w[..., None]).sum() / (2 * norm + 1e-6)
    return out


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of every entry of the loss dict."""
    return sum(losses.values())
