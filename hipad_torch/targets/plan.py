"""Planning target selection (counterpart of ``hipad_tpu/targets/plan.py``):
the active command's modes are sliced, the winner-take-all mode is the one
with the smallest masked cumulative-L2 distance to the GT."""

from __future__ import annotations

import torch


def get_cls_target(reg_preds, reg_target, reg_weight) -> torch.Tensor:
    """reg_preds ``[bs, 1, mode, ts, 2]``; reg_target ``[bs, 1, ts, 2]``;
    reg_weight ``[bs, 1, ts]`` -> ``[bs, 1]`` mode index."""
    pred_cum = torch.cumsum(reg_preds, dim=-2)
    tgt_cum = torch.cumsum(reg_target, dim=-2)
    dist = torch.linalg.vector_norm(tgt_cum[:, :, None] - pred_cum, dim=-1)
    dist = (dist * reg_weight[:, :, None]).mean(dim=-1)
    return torch.argmin(dist, dim=-1)


def take_mode(reg_preds, mode_idx) -> torch.Tensor:
    """``[bs, 1, mode, ts, 2]`` x ``[bs, 1]`` -> ``[bs, 1, ts, 2]``."""
    idx = mode_idx[..., None, None, None].expand(mode_idx.shape + (1,) + reg_preds.shape[-2:])
    return torch.gather(reg_preds, 2, idx).squeeze(2)


def select_cmd(cls_pred, reg_pred, cmd_onehot, ego_fut_cmd: int, ego_fut_ts: int):
    """Slice the active command's modes: cls ``[bs, 1, cmd*mode]``, reg
    ``[bs, 1, cmd*mode, ts, 2]`` -> ``[bs, 1, mode]``, ``[bs, 1, mode, ts, 2]``."""
    bs = cls_pred.shape[0]
    if ego_fut_cmd == 1:
        return cls_pred, reg_pred
    cmd = torch.argmax(cmd_onehot, dim=-1)
    bidx = torch.arange(bs, device=cmd.device)
    return (cls_pred.reshape(bs, ego_fut_cmd, 1, -1)[bidx, cmd],
            reg_pred.reshape(bs, ego_fut_cmd, 1, -1, ego_fut_ts, 2)[bidx, cmd])


def sparse_plan_target(cls_pred, reg_pred, gt_trajs, gt_masks, cmd_onehot,
                       ego_fut_cmd: int, ego_fut_ts: int):
    """-> (cls [bs,1,mode], cls_target [bs,1], cls_weight [bs,1],
    best_reg [bs,1,ts,2], gt [bs,1,ts,2], gt_mask [bs,1,ts])."""
    gt, gm = gt_trajs[:, None], gt_masks[:, None]
    cls_pred, reg_pred = select_cmd(cls_pred, reg_pred, cmd_onehot, ego_fut_cmd, ego_fut_ts)
    cls_target = get_cls_target(reg_pred, gt, gm)
    cls_weight = (gm > 0).any(dim=-1)
    return cls_pred, cls_target, cls_weight, take_mode(reg_pred, cls_target), gt, gm


def align_plan_target(cls_pred, reg_pred, gt_trajs, gt_masks, cmd_onehot, ref_target,
                      ego_fut_cmd: int, ego_fut_ts: int):
    """As :func:`sparse_plan_target` with the positive mode forced to the
    reference anchor type's winner ``ref_target``."""
    gt, gm = gt_trajs[:, None], gt_masks[:, None]
    cls_pred, reg_pred = select_cmd(cls_pred, reg_pred, cmd_onehot, ego_fut_cmd, ego_fut_ts)
    cls_weight = (gm > 0).any(dim=-1)
    return cls_pred, ref_target, cls_weight, take_mode(reg_pred, ref_target), gt, gm
