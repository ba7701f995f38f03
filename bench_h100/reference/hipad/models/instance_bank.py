# Frozen copy of hipad_torch/models/instance_bank.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Temporal instance banks as plain dataclasses of tensors (counterpart of
``hipad_tpu/models/instance_bank.py``).

Per-sample sequence resets follow the time mask (a gap above
``max_time_interval`` resets that sample). The first frame, with no cache,
is the separate case ``state=None``.

Every top-k here is ``ops.ranking.topk``: ties go to the lower index, as
with ``lax.top_k``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.box3d import VX
from ..core.geometry import box_anchor_projection, fp32
from ..ops import ranking


@dataclasses.dataclass
class DetBankState:
    feature: torch.Tensor  # [bs, K, C]
    anchor: torch.Tensor  # [bs, K, 11]
    confidence: torch.Tensor  # [bs, K]
    instance_id: torch.Tensor  # [bs, num_anchor] int32 (-1 = unassigned)
    prev_id: torch.Tensor  # [bs] int32 id counter
    timestamp: torch.Tensor  # [bs]
    t_global: torch.Tensor  # [bs, 4, 4]


@dataclasses.dataclass
class EgoBankState:
    feature: torch.Tensor  # [bs, 1, C]
    anchor: torch.Tensor  # [bs, 1, 11]
    timestamp: torch.Tensor  # [bs]


@dataclasses.dataclass
class PlanBankState:
    feature: torch.Tensor  # [bs, G*cmd, M, C]
    anchor: torch.Tensor  # [bs, G*cmd, M, ts*2]
    confidence: torch.Tensor  # [bs, G*cmd, M]
    timestamp: torch.Tensor  # [bs]


@dataclasses.dataclass
class BankStates:
    det: DetBankState
    ego: EgoBankState
    plan: PlanBankState


def map_banks(fn, *banks: BankStates) -> BankStates:
    """``fn`` over the matching tensors of one or more bank states ->
    BankStates (``jax.tree.map`` over the JAX package's bank pytree)."""
    return BankStates(*(
        dataclasses.replace(parts[0], **{f.name: fn(*(getattr(p, f.name) for p in parts))
                                         for f in dataclasses.fields(parts[0])})
        for parts in zip(*((b.det, b.ego, b.plan) for b in banks))))


def init_bank_states(cfg, batch_size: int, device, feature_dtype=torch.float32) -> BankStates:
    """Zeroed cold-start banks (``hipad_tpu/models/instance_bank.py:
    init_bank_states``): zero confidence and a timestamp far in the past,
    so that every sample fails the ``max_time_interval`` check and the cache
    is ignored, through the temporal path. The gradient-accumulation step
    starts each micro-batch's bank slice from these."""
    C, bs = cfg.embed_dims, batch_size
    f32 = dict(dtype=torch.float32, device=device)
    t_old = torch.full((bs,), -1e9, **f32)
    g = cfg.plan_anchor_group * cfg.ego_fut_cmd
    return BankStates(
        det=DetBankState(
            feature=torch.zeros(bs, cfg.num_temp_det_anchor, C, dtype=feature_dtype,
                                device=device),
            anchor=torch.zeros(bs, cfg.num_temp_det_anchor, 11, **f32),
            confidence=torch.zeros(bs, cfg.num_temp_det_anchor, **f32),
            instance_id=torch.full((bs, cfg.num_det_anchor), -1, dtype=torch.int32,
                                   device=device),
            prev_id=torch.zeros(bs, dtype=torch.int32, device=device),
            timestamp=t_old, t_global=torch.eye(4, **f32).repeat(bs, 1, 1)),
        ego=EgoBankState(
            feature=torch.zeros(bs, 1, C, dtype=feature_dtype, device=device),
            anchor=torch.as_tensor(np.asarray(cfg.ego_anchor_init, np.float32),
                                   device=device)[None].repeat(bs, 1, 1),
            timestamp=t_old.clone()),
        plan=PlanBankState(
            feature=torch.zeros(bs, g, cfg.num_temp_plan_mode, C, dtype=feature_dtype,
                                device=device),
            anchor=torch.zeros(bs, g, cfg.num_temp_plan_mode, cfg.ego_fut_ts * 2, **f32),
            confidence=torch.zeros(bs, g, cfg.num_temp_plan_mode, **f32),
            timestamp=t_old.clone()))


def topk_gather(confidence: torch.Tensor, k: int, *inputs):
    """Top-k rows along dim 1 by ``confidence [bs, n]`` (ties -> lower index)
    -> (top confidences, [x gathered at the top rows for x in inputs])."""
    conf, idx = ranking.topk(confidence, k)
    outs = [torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])) for x in inputs]
    return conf, outs


def det_cold_layout(cfg) -> np.ndarray:
    """Permutation placing confidence-sorted ranks into the [temporal |
    fresh] segment geometry by Bresenham round-robin, so that every
    proportional prefix keeps the global top-k (``with_topk_det`` on a cold
    sample). ``layout[s] = sorted[inv[s]]``."""
    nt, nd = cfg.num_temp_det_anchor, cfg.num_det_anchor
    r = np.arange(nd)
    ct = (r * nt) // nd
    in_t = ((r + 1) * nt) // nd > ct
    slot = np.where(in_t, ct, nt + (r - ct))
    inv = np.empty(nd, np.int64)
    inv[slot] = r
    return inv


def cold_layout(cfg, confidence: torch.Tensor, *inputs):
    """``inputs`` (rows along dim 1) sorted by ``confidence`` and laid into
    the segment geometry by :func:`det_cold_layout`."""
    _, outs = topk_gather(confidence, cfg.num_det_anchor, *inputs)
    inv = torch.as_tensor(det_cold_layout(cfg), device=confidence.device)
    return [x[:, inv] for x in outs]


@fp32
def det_bank_get(cfg, state: Optional[DetBankState], batch_size: int,
                 timestamp: torch.Tensor, t_global: torch.Tensor,
                 t_global_inv: torch.Tensor):
    """-> (temp_feature, temp_anchor projected to the current frame,
    time_interval [bs], mask [bs])."""
    if state is None:
        ti = torch.full((batch_size,), cfg.default_time_interval,
                        dtype=torch.float32, device=timestamp.device)
        return None, None, ti, None
    dt = (timestamp - state.timestamp).float()
    mask = dt.abs() <= cfg.max_time_interval
    t_temp2cur = torch.einsum("bij,bjk->bik", t_global_inv, state.t_global)
    temp_anchor = box_anchor_projection(state.anchor, t_temp2cur, time_interval=-dt)
    ti = torch.where(mask & (dt != 0), dt, torch.full_like(dt, cfg.default_time_interval))
    return state.feature, temp_anchor, ti, mask


def det_bank_update(cfg, state: DetBankState, temp_feature, temp_anchor,
                    instance_feature, anchor, cls_logits, mask,
                    sort_fresh_full: bool = False):
    """Merge after the single-frame layer: keep the top-(N-K) fresh
    detections behind the K cached instances; samples whose time gap is
    invalid keep the fresh set and zero their cached confidence and ids.

    ``sort_fresh_full`` (``with_topk_det``): those samples keep the whole
    fresh set sorted by confidence and laid into the segment geometry
    (:func:`det_cold_layout`), so that the prefix pruning downstream keeps
    the top-k single-frame detections, not an arbitrary anchor prefix."""
    n_fresh = cfg.num_det_anchor - cfg.num_temp_det_anchor
    conf = cls_logits.max(dim=-1).values
    _, (sel_feat, sel_anchor) = topk_gather(conf, n_fresh, instance_feature, anchor)
    merged_feat = torch.cat([temp_feature, sel_feat], dim=1)
    merged_anchor = torch.cat([temp_anchor, sel_anchor], dim=1)
    fresh_feat, fresh_anchor = instance_feature, anchor
    if sort_fresh_full:
        fresh_feat, fresh_anchor = cold_layout(cfg, conf, instance_feature, anchor)
    out_feat = torch.where(mask[:, None, None], merged_feat, fresh_feat)
    out_anchor = torch.where(mask[:, None, None], merged_anchor, fresh_anchor)
    new_state = dataclasses.replace(
        state,
        confidence=torch.where(mask[:, None], state.confidence,
                               torch.zeros_like(state.confidence)),
        instance_id=torch.where(mask[:, None], state.instance_id,
                                torch.full_like(state.instance_id, -1)),
    )
    return out_feat, out_anchor, new_state


def det_bank_cache(cfg, prev_confidence: Optional[torch.Tensor], instance_feature,
                   anchor, cls_logits, timestamp, t_global) -> Tuple[DetBankState, torch.Tensor]:
    """Cache the top-K instances with confidence decay -> (state without
    ids, temp_confidence)."""
    k = cfg.num_temp_det_anchor
    conf = torch.sigmoid(cls_logits.max(dim=-1).values)
    cls_ids = cls_logits.argmax(dim=-1)
    if prev_confidence is not None:
        decayed = torch.maximum(prev_confidence * cfg.confidence_decay, conf[:, :k])
        conf = torch.cat([decayed, conf[:, k:]], dim=1)
    temp_confidence = conf
    new_conf, (feat, anc, ids) = topk_gather(
        conf, k, instance_feature.detach(), anchor.detach(), cls_ids[..., None])
    # zero velocity for static classes
    static = torch.as_tensor(cfg.zero_velocity_class_ids, device=ids.device)
    is_static = torch.isin(ids[..., 0], static)
    anc = torch.cat([anc[..., :VX], torch.where(is_static[..., None],
                                                torch.zeros_like(anc[..., VX:]),
                                                anc[..., VX:])], dim=-1)
    bs = anchor.shape[0]
    state = DetBankState(
        feature=feat,
        anchor=anc,
        confidence=new_conf,
        instance_id=torch.full((bs, cfg.num_det_anchor), -1, dtype=torch.int32,
                               device=anchor.device),
        prev_id=torch.zeros((bs,), dtype=torch.int32, device=anchor.device),
        timestamp=timestamp,
        t_global=t_global,
    )
    return state, temp_confidence


def det_assign_instance_ids(cfg, old_state: Optional[DetBankState], new_state: DetBankState,
                            temp_confidence, cls_logits,
                            score_threshold: Optional[float] = None):
    """Persistent tracking ids: anchors with a cached id keep it, the others
    (optionally above a score threshold) take fresh sequential ids; the ids
    of the top-K by temp confidence are cached for the next frame."""
    bs = cls_logits.shape[0]
    n, k = cfg.num_det_anchor, cfg.num_temp_det_anchor
    dev = cls_logits.device
    if old_state is not None:
        instance_id, prev_id = old_state.instance_id, old_state.prev_id
    else:
        instance_id = torch.full((bs, n), -1, dtype=torch.int32, device=dev)
        prev_id = torch.zeros((bs,), dtype=torch.int32, device=dev)
    need = instance_id < 0
    if score_threshold is not None:
        need = need & (torch.sigmoid(cls_logits.max(dim=-1).values) >= score_threshold)
    new_ids = prev_id[:, None] + torch.cumsum(need.int(), dim=1, dtype=torch.int32) - 1
    instance_id = torch.where(need, new_ids, instance_id)
    prev_id = prev_id + need.sum(dim=1, dtype=torch.int32)
    _, (kept,) = topk_gather(temp_confidence, k, instance_id[..., None])
    cached_ids = torch.cat([kept[..., 0], torch.full((bs, n - k), -1, dtype=torch.int32,
                                                     device=dev)], dim=1)
    return instance_id, dataclasses.replace(new_state, instance_id=cached_ids, prev_id=prev_id)


def ego_bank_get(state: Optional[EgoBankState]):
    if state is None:
        return None, None
    return state.feature, state.anchor


def ego_bank_cache(instance_feature, anchor, timestamp) -> EgoBankState:
    return EgoBankState(feature=instance_feature.detach(), anchor=anchor.detach(),
                        timestamp=timestamp)


def plan_bank_get(cfg, state: Optional[PlanBankState]):
    if state is None:
        return None, None
    bs = state.feature.shape[0]
    return (state.feature.reshape(bs, -1, state.feature.shape[-1]),
            state.anchor.reshape(bs, -1, cfg.ego_fut_ts * 2))


def plan_bank_cache(cfg, prev_confidence: Optional[torch.Tensor], instance_feature,
                    anchor, cls_logits, timestamp) -> PlanBankState:
    """Per (anchor group x cmd) block of modes, cache the top
    ``num_temp_plan_mode`` with confidence decay."""
    bs = anchor.shape[0]
    g = cfg.plan_anchor_group * cfg.ego_fut_cmd
    m, k = cfg.ego_fut_mode, cfg.num_temp_plan_mode
    d = instance_feature.shape[-1]
    feat = instance_feature.detach().reshape(bs * g, m, d)
    anc = anchor.detach().reshape(bs * g, m, cfg.ego_fut_ts * 2)
    conf = torch.sigmoid(cls_logits.detach().reshape(bs * g, m))
    if prev_confidence is not None:
        decayed = torch.maximum(prev_confidence.reshape(bs * g, k) * cfg.confidence_decay,
                                conf[:, :k])
        conf = torch.cat([decayed, conf[:, k:]], dim=1)
    new_conf, (cf, ca) = topk_gather(conf, k, feat, anc)
    return PlanBankState(
        feature=cf.reshape(bs, g, k, d),
        anchor=ca.reshape(bs, g, k, cfg.ego_fut_ts * 2),
        confidence=new_conf.reshape(bs, g, k),
        timestamp=timestamp,
    )
