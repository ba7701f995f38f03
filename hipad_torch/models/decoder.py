"""Unified sparse decoder over the concatenated multi-task query set
(counterpart of ``hipad_tpu/models/decoder.py``).

The decoder program is data: ``cfg.operation_order`` is a flat tuple of op
names (concat / temp_gnn / gnn / inter_gnn / norm / split / deformable / ffn
/ refine) run by a Python loop. Every submodule is named after its flax
path (``gnn_{op_idx}``, ``{task}_deformable_{i}``, ``det_refine_{i}`` ...).
The temporal banks are passed in and returned; the first frame is the case
``bank_states=None``. In train mode (``module.train()``) the attention, FFN
and deformable dropouts draw from the ``generator`` passed to the forward,
and the front-view BatchNorms use batch statistics.

The serving knobs run as in the JAX package:

  * ``with_topk_det`` prunes det queries after each refine layer from the
    merge on, by static prefix slices of the two confidence-sorted bank
    segments (temporal | fresh). Dropped queries freeze at their drop-layer
    state; the per-layer output stacks and the end-of-frame bank interfaces
    are re-spliced to the full width from the frozen tails. A first frame
    sorts the fresh set by confidence and lays it into the segment geometry
    (``instance_bank.det_cold_layout``);
  * ``with_topk_mode`` keeps the top ``topk_mode_list[i]`` plan modes per
    anchor group after refine layer ``i``; the output stacks and the cached
    plan tensors are padded back to the full mode count with cls ``-1e9``,
    reg ``+1e6`` (zero features);
  * ``sampler_point_frac`` is the deformable op's keypoint top-k, and
    ``sampler_level_k`` its fine-level top-k.

And the model options off in every shipped config:

  * ``with_distance_attn_mask`` / ``with_velocity_attn_mask`` add the
    biases of ``attn_masks.py`` into the inter_gnn op's logits, each scaled
    by a per-head tau head (``distance_tau_{op_idx}``,
    ``velocity_tau_{op_idx}``);
  * with any per-point option on, a task's anchor encoder is the
    ``KeyPoint3DEncoder``, which also embeds each polyline point.
    ``with_concat_*_points`` expands each map (plan) query into its points
    in the concat op (its feature repeated per point, interleaved, beside
    the point embeds) and squeezes them back to one query in the split op
    (``squeeze_map_instance`` / ``squeeze_plan_instance``);
    ``with_deform_*_points`` feeds the point embeds to the deformable op's
    weights head.

:func:`check_supported` refuses the rest by name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.geometry import agent_to_lidar_trajs, sine_embed_2d
from ..ops import ranking
from ..ops.sampling import front_view_feature
from ..utils.spans import span
from . import attn_masks
from . import instance_bank as banks
from .attention_blocks import (GroupedCrossAttention, cross_attention_groups,
                               self_attention_groups)
from .common import MLP, MLPLN, AsymmetricFFN, BatchNorm, LayerNorm
from .deformable import DeformableAggregation
from .encoders import KeyPoint3DEncoder, SparseBox3DEncoder, SparsePoint3DEncoder
from .keypoints import BoxKeypoints, PointKeypoints
from .refine import (EgoStatusRefinement, SparseBox3DRefinement, SparseMotionRefinement,
                     SparsePlanAlignRefinement, SparsePoint3DRefinement)


def check_supported(cfg) -> None:
    """Refuse, loudly, every knob the port does not run."""
    nsf = cfg.num_single_frame_decoder
    if nsf < 1:
        raise NotImplementedError("hipad_torch needs num_single_frame_decoder >= 1")
    ks = cfg.topk_det_list[:cfg.operation_order.count("refine")] if cfg.with_topk_det else ()
    refused = [
        (ks and ks[nsf - 1] < cfg.num_det_anchor,
         f"with_topk_det pruning at the merge layer (topk_det_list[{nsf - 1}] < "
         f"num_det_anchor): the JAX package takes that layer's cls/quality tails from the "
         f"pre-merge order", "ROADMAP queue 3 (prune only after the merge layer)"),
        (len(ks) >= 2 and ks[-1] < ks[-2],
         "with_topk_det pruning after the last refine layer: the JAX package splices the "
         "new tails into that layer's unpruned cls for the bank cache",
         "ROADMAP queue 3 (prune only before the last layer)"),
        (cfg.sampler_row_packed, "sampler_row_packed",
         "ROADMAP queue 1, item 14 (not ported: measured slower on the TPU)"),
        (cfg.fused_deformable, "fused_deformable",
         "ROADMAP queue 1, item 14 (not ported: measured slower on the TPU)"),
    ]
    for on, what, item in refused:
        if on:
            raise NotImplementedError(f"hipad_torch does not run {what} yet: {item}")


class FrontViewEncoder(nn.Module):
    """Front-camera global feature: conv3x3-BN-conv3x3/2-BN-ReLU, then the mean
    of the FIRST pooling window, whose kernel is half the PRE-conv dims (for
    odd dims the reference's single AvgPool window drops the trailing
    row/col)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.conv1 = nn.Conv2d(embed_dims, embed_dims, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(embed_dims)
        self.conv2 = nn.Conv2d(embed_dims, embed_dims, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm(embed_dims)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        """fmap [bs, H, W, C] -> [bs, C]."""
        h, w = fmap.shape[1:3]
        x = fmap.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        x = self.bn1(self.conv1(x))
        x = F.relu(self.bn2(self.conv2(x)))
        kh = max(1, min(x.shape[2], h // 2))
        kw = max(1, min(x.shape[3], w // 2))
        return x[:, :, :kh, :kw].mean(dim=(2, 3))


class SparseOneDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        C = cfg.embed_dims
        L = cfg.num_levels

        # bank parameters and constants: copies (torch.tensor), never views of
        # the config's arrays, which the optimizer would otherwise update
        self.det_anchor = nn.Parameter(torch.tensor(np.asarray(cfg.det_anchor, np.float32)))
        self.det_feature = nn.Parameter(torch.zeros(cfg.num_det_anchor, C))
        self.map_anchor = nn.Parameter(torch.tensor(np.asarray(cfg.map_anchor, np.float32)))
        self.map_feature = nn.Parameter(torch.zeros(cfg.num_map_anchor, C))
        self.plan_anchor = nn.Parameter(torch.tensor(np.asarray(cfg.plan_anchor, np.float32)))
        self.register_buffer("ego_anchor_init", torch.tensor(cfg.ego_anchor_init),
                             persistent=False)
        self.register_buffer("motion_anchor", torch.tensor(
            np.asarray(cfg.motion_anchor, np.float32)), persistent=False)

        # shared submodules; a task with any per-point option embeds its
        # points too (KeyPoint3DEncoder)
        self.det_anchor_encoder = SparseBox3DEncoder((C // 2, C // 8, C // 8, C // 4))
        self.per_point = {
            "map": cfg.with_concat_map_points or cfg.with_deform_map_points,
            "plan": cfg.with_concat_plan_points or cfg.with_deform_plan_points}
        # points per query in the concat op (0: not expanded) and in the
        # deformable op's weights head (0: the instance embed)
        self.expand_S = {"map": cfg.map_num_pts * cfg.with_concat_map_points,
                         "plan": cfg.ego_fut_ts * cfg.with_concat_plan_points}
        self.deform_S = {"map": cfg.map_num_pts * cfg.with_deform_map_points,
                         "plan": cfg.ego_fut_ts * cfg.with_deform_plan_points}
        for q, n_pts in (("map", cfg.map_num_pts), ("plan", cfg.ego_fut_ts)):
            self.add_module(f"{q}_anchor_encoder",
                            KeyPoint3DEncoder(C, n_pts) if self.per_point[q]
                            else SparsePoint3DEncoder(n_pts * 2, C))
        if cfg.with_concat_map_points:
            self.squeeze_map_instance = MLP(cfg.map_num_pts * C,
                                            (cfg.map_num_pts * C // 4, C, C))
        if cfg.with_concat_plan_points:
            self.squeeze_plan_instance = MLP(cfg.ego_fut_ts * C,
                                             (cfg.ego_fut_ts * C // 2, C, C))
        self.ego_feature_encoder = FrontViewEncoder(C)
        self.plan_feature_encoder = FrontViewEncoder(C)
        self.fc_before = nn.Linear(C, C * 2, bias=False)
        self.fc_after = nn.Linear(C * 2, C, bias=False)
        if cfg.with_target_point_embed:
            self.target_point_encoder_mlp = MLPLN(C, C, 2, 1)
            self.target_point_encoder_out = nn.Linear(C, C)
        if cfg.with_command_embed:
            self.command_encoder_mlp = MLPLN(cfg.num_command, C, 2, 1)
            self.command_encoder_out = nn.Linear(C, C)
        self.with_motion = "motion" in cfg.task_select
        if self.with_motion:
            self.motion_anchor_encoder_mlp = MLPLN(C, C, 1, 1)
            self.motion_anchor_encoder_out = nn.Linear(C, C)

        self.gnn_groups = self_attention_groups([("det",), ("map",)], [True, False])
        self.temp_groups = cross_attention_groups(
            [("det",), ("map",), ("plan", "ego")],
            [("det",), ("map",), ("det", "map")],
            [True, False, False],
        )
        self.inter_groups = cross_attention_groups([("plan", "ego")], [("det", "map")], [False])

        kps_specs = {"det": (BoxKeypoints, cfg.det_kps), "map": (PointKeypoints, cfg.map_kps),
                     "plan": (PointKeypoints, cfg.plan_kps), "ego": (BoxKeypoints, cfg.ego_kps)}
        deform_i = refine_i = 0
        for op_idx, op in enumerate(cfg.operation_order):
            if op == "gnn":
                self.add_module(f"gnn_{op_idx}",
                                GroupedCrossAttention(C, cfg.num_groups, self.gnn_groups,
                                                      cfg.drop_out))
            elif op == "temp_gnn":
                self.add_module(f"temp_gnn_{op_idx}",
                                GroupedCrossAttention(C, cfg.num_groups, self.temp_groups,
                                                      cfg.drop_out))
            elif op == "inter_gnn":
                self.add_module(f"inter_gnn_{op_idx}",
                                GroupedCrossAttention(C, cfg.num_groups, self.inter_groups,
                                                      cfg.drop_out))
                if cfg.with_distance_attn_mask:
                    self.add_module(f"distance_tau_{op_idx}",
                                    attn_masks.TauHead(C, cfg.num_groups))
                if cfg.with_velocity_attn_mask:
                    self.add_module(f"velocity_tau_{op_idx}",
                                    attn_masks.TauHead(C, cfg.num_groups))
            elif op == "norm":
                self.add_module(f"norm_{op_idx}", LayerNorm(C, eps=1e-5))
            elif op == "ffn":
                self.add_module(f"ffn_{op_idx}", AsymmetricFFN(C * 2, C, C * 4, cfg.drop_out))
            elif op == "deformable":
                for q in cfg.query_select:
                    kps_cls, spec = kps_specs[q]
                    kps = kps_cls(spec, C)
                    self.add_module(f"{q}_kps_{deform_i}", kps)
                    self.add_module(f"{q}_deformable_{deform_i}", DeformableAggregation(
                        C, cfg.num_groups, L, cfg.num_cams, kps.num_pts,
                        sampler=cfg.sampler, sampler_cam_k=cfg.sampler_cam_k,
                        sampler_cam_renorm=cfg.sampler_cam_renorm,
                        sampler_matmul_levels=cfg.sampler_matmul_levels,
                        sampler_point_frac=cfg.sampler_point_frac,
                        sampler_level_k=cfg.sampler_level_k,
                        sampler_level_renorm=cfg.sampler_level_renorm,
                        use_points_embed=self.deform_S.get(q, 0)))
                deform_i += 1
            elif op == "refine":
                self.add_module(f"det_refine_{refine_i}",
                                SparseBox3DRefinement(cfg, cfg.num_det_classes))
                self.add_module(f"map_refine_{refine_i}", SparsePoint3DRefinement(
                    cfg, cfg.num_map_classes, cfg.map_num_pts * 2))
                if self.with_motion:
                    self.add_module(f"motion_refine_{refine_i}", SparseMotionRefinement(cfg))
                self.add_module(f"ego_refine_{refine_i}", EgoStatusRefinement(cfg))
                self.add_module(f"plan_refine_{refine_i}", SparsePlanAlignRefinement(cfg))
                refine_i += 1
            elif op not in ("concat", "split"):
                raise NotImplementedError(f"unknown op {op!r}")

    def _inter_bias(self, op_idx: int, feat, anchor) -> Optional[Dict[int, torch.Tensor]]:
        """The inter_gnn op's attention biases (``attn_masks.py``) for its one
        group, summed, or None with both masks off. Each tau head reads the
        group's query features."""
        cfg = self.cfg
        if not (cfg.with_distance_attn_mask or cfg.with_velocity_attn_mask):
            return None
        q_names, k_names, _ = self.inter_groups[0]
        q_feat = torch.cat([feat[m] for m in q_names], dim=1)
        bias = 0.0
        if cfg.with_distance_attn_mask:
            tau = getattr(self, f"distance_tau_{op_idx}")(q_feat)
            bias = bias + attn_masks.distance_bias(
                attn_masks.min_distance_matrix(q_names, k_names, anchor), tau)
        if cfg.with_velocity_attn_mask:
            tau = getattr(self, f"velocity_tau_{op_idx}")(q_feat)
            bias = bias + attn_masks.velocity_bias(
                attn_masks.speed_diff_matrix(q_names, k_names, anchor), tau)
        return {0: bias}

    def forward(self, feature_maps: Sequence[torch.Tensor], metas: Dict[str, torch.Tensor],
                bank_states: Optional[banks.BankStates] = None,
                generator: Optional[torch.Generator] = None):
        with span("decoder.init"):
            cfg = self.cfg
            C = cfg.embed_dims
            bs = feature_maps[0].shape[0]
            has_temp = bank_states is not None
            qs = cfg.query_select
            det_enc = self.det_anchor_encoder

            timestamp = metas["timestamp"]
            projection_mat = metas["projection_mat"]
            image_wh = metas["image_wh"]

            # ---- query init (banks .get) -------------------------------------
            feat: Dict[str, Optional[torch.Tensor]] = {}
            anchor: Dict[str, torch.Tensor] = {}
            embed: Dict[str, Optional[torch.Tensor]] = {}
            tfeat: Dict[str, Optional[torch.Tensor]] = {}
            tembed: Dict[str, Optional[torch.Tensor]] = {}

            det_feature = self.det_feature if cfg.det_feat_grad else self.det_feature.detach()
            feat["det"] = det_feature[None].expand(bs, -1, -1)
            anchor["det"] = self.det_anchor[None].expand(bs, -1, -1)
            temp_det_feat, temp_det_anchor, time_interval, det_mask = banks.det_bank_get(
                cfg, bank_states.det if has_temp else None, bs, timestamp,
                metas["T_global"], metas["T_global_inv"])
            embed["det"] = det_enc(anchor["det"])
            tfeat["det"] = temp_det_feat
            tembed["det"] = det_enc(temp_det_anchor) if has_temp else None

            # per-point embeds [bs, n * points, C] (tasks with a per-point option)
            pts_embed: Dict[str, Optional[torch.Tensor]] = {"map": None, "plan": None}
            temp_pts_embed: Dict[str, Optional[torch.Tensor]] = {"map": None, "plan": None}

            def encode(q, a):
                """-> (instance embed, per-point embed or None) of map/plan anchors."""
                enc = getattr(self, f"{q}_anchor_encoder")
                return enc(a) if self.per_point[q] else (enc(a), None)

            feat["map"] = self.map_feature[None].expand(bs, -1, -1)
            anchor["map"] = self.map_anchor[None].expand(bs, -1, -1)
            embed["map"], pts_embed["map"] = encode("map", anchor["map"])
            tfeat["map"] = tembed["map"] = None

            front = front_view_feature(feature_maps)
            plan_base = self.plan_feature_encoder(front)  # [bs, C]
            feat["plan"] = plan_base[:, None].expand(-1, cfg.num_plan_anchor, -1)
            anchor["plan"] = self.plan_anchor[None].expand(bs, -1, -1)
            embed["plan"], pts_embed["plan"] = encode("plan", anchor["plan"])
            temp_plan_feat, temp_plan_anchor = banks.plan_bank_get(
                cfg, bank_states.plan if has_temp else None)
            tfeat["plan"] = temp_plan_feat
            tembed["plan"] = None
            if has_temp:
                tembed["plan"], temp_pts_embed["plan"] = encode("plan", temp_plan_anchor)

            feat["ego"] = self.ego_feature_encoder(front)[:, None]  # [bs, 1, C]
            anchor["ego"] = self.ego_anchor_init[None].expand(bs, -1, -1)
            embed["ego"] = det_enc(anchor["ego"])
            temp_ego_feat, temp_ego_anchor = banks.ego_bank_get(
                bank_states.ego if has_temp else None)
            tfeat["ego"] = temp_ego_feat
            tembed["ego"] = det_enc(temp_ego_anchor) if has_temp else None

            def joint_pair(f_d, e_d, p_d):
                """Concatenate features and embeds over query_select; a
                point-expanded task's features are repeated per point
                (interleaved) beside its point embeds."""
                fparts, eparts, sections, start = [], [], {}, 0
                for q in qs:
                    f, e = f_d[q], e_d[q]
                    if f is None:
                        f = e = torch.zeros((bs, 0, C), dtype=torch.float32,
                                            device=feature_maps[0].device)
                    S = self.expand_S.get(q, 0)
                    if S and f.shape[1]:
                        f, e = f.repeat_interleave(S, dim=1), p_d[q]
                    fparts.append(f)
                    eparts.append(e)
                    sections[q] = (start, start + f.shape[1])
                    start += f.shape[1]
                return torch.cat(fparts, dim=1), torch.cat(eparts, dim=1), sections

            out: Dict[str, Dict[str, List]] = {
                "det": {"classification": [], "prediction": [], "quality": []},
                "map": {"classification": [], "prediction": []},
                "ego": {"status": []},
                "plan": {"classification": [], "prediction": []},
                "motion": {"classification": [], "prediction": []},
            }
            det_bank_state = bank_states.det if has_temp else None
            det_cls = plan_cls = None
            joint_feat = joint_embed = None
            temp_joint_feat = temp_joint_embed = None
            cur_sections = temp_sections = None
            deform_i = refine_i = 0

            # det-query pruning: ``det_live`` = live (temporal, fresh) prefix
            # lengths; ``det_tails`` maps an output key to the (temporal, fresh)
            # rows frozen at their drop layer, in ascending original-slot order
            det_prune = cfg.with_topk_det and cfg.topk_det_list is not None
            nt, nd = cfg.num_temp_det_anchor, cfg.num_det_anchor
            det_live = (nt, nd - nt)
            det_tails: Dict[str, tuple] = {}

            def det_splice(live, key):
                """A live det tensor back at the full slot layout: the frozen
                tails spliced behind each segment's live prefix."""
                if key not in det_tails:
                    return live
                tail_t, tail_f = det_tails[key]
                tk = det_live[0]
                return torch.cat([live[:, :tk], tail_t, live[:, tk:], tail_f], dim=1)

            ng = cfg.plan_anchor_group
            per_full = cfg.ego_fut_cmd * cfg.ego_fut_mode

            def pad_modes(x, fill):
                """Pruned per-group plan modes padded back to ``per_full``."""
                k = x.shape[1] // ng
                if k == per_full:
                    return x
                xg = x.reshape((bs, ng, k) + x.shape[2:])
                pad = torch.full((bs, ng, per_full - k) + x.shape[2:], fill, dtype=x.dtype,
                                 device=x.device)
                return torch.cat([xg, pad], dim=2).reshape((bs, ng * per_full) + x.shape[2:])

        for op_idx, op in enumerate(cfg.operation_order):
            with span("decoder." + op):
                if op == "concat":
                    joint_feat, joint_embed, cur_sections = joint_pair(feat, embed, pts_embed)
                    if has_temp:
                        temp_joint_feat, temp_joint_embed, temp_sections = joint_pair(
                            tfeat, tembed, temp_pts_embed)

                elif op == "split":
                    for q in qs:
                        s, e = cur_sections[q]
                        S = self.expand_S.get(q, 0)
                        if S and e > s:
                            # the S point features of each query squeezed back to one
                            squeeze = getattr(self, f"squeeze_{q}_instance")
                            feat[q] = squeeze(joint_feat[:, s:e].reshape(bs, (e - s) // S, S * C))
                            pts_embed[q] = joint_embed[:, s:e]
                        else:
                            feat[q] = joint_feat[:, s:e]
                            embed[q] = joint_embed[:, s:e]

                elif op == "gnn":
                    joint_feat = getattr(self, f"gnn_{op_idx}")(
                        joint_feat, joint_embed, cur_sections, self.fc_before, self.fc_after,
                        generator=generator)

                elif op == "temp_gnn":
                    joint_feat = getattr(self, f"temp_gnn_{op_idx}")(
                        joint_feat, joint_embed, cur_sections, self.fc_before, self.fc_after,
                        key_x=temp_joint_feat, key_pos=temp_joint_embed,
                        key_sections=temp_sections, has_value=has_temp, generator=generator)

                elif op == "inter_gnn":
                    joint_feat = getattr(self, f"inter_gnn_{op_idx}")(
                        joint_feat, joint_embed, cur_sections, self.fc_before, self.fc_after,
                        key_x=joint_feat, key_pos=joint_embed, key_sections=cur_sections,
                        attn_bias=self._inter_bias(op_idx, feat, anchor), generator=generator)

                elif op == "norm":
                    joint_feat = getattr(self, f"norm_{op_idx}")(joint_feat)

                elif op == "ffn":
                    joint_feat = getattr(self, f"ffn_{op_idx}")(joint_feat, generator)

                elif op == "deformable":
                    for q in qs:
                        with span("deformable." + q):
                            feat[q] = getattr(self, f"{q}_deformable_{deform_i}")(
                                getattr(self, f"{q}_kps_{deform_i}"), feat[q], anchor[q],
                                pts_embed[q] if self.deform_S.get(q, 0) else embed[q],
                                feature_maps, projection_mat, image_wh, generator)
                    deform_i += 1

                elif op == "refine":
                    # ---- det -------------------------------------------------
                    anchor["det"], det_cls, det_qt = getattr(self, f"det_refine_{refine_i}")(
                        feat["det"], anchor["det"], embed["det"], time_interval)
                    out["det"]["prediction"].append(det_splice(anchor["det"], "prediction"))
                    out["det"]["classification"].append(det_splice(det_cls, "classification"))
                    out["det"]["quality"].append(det_splice(det_qt, "quality"))
                    if refine_i + 1 == cfg.num_single_frame_decoder:
                        if has_temp:
                            feat["det"], anchor["det"], det_bank_state = banks.det_bank_update(
                                cfg, det_bank_state, temp_det_feat, temp_det_anchor,
                                feat["det"], anchor["det"], det_cls, det_mask,
                                sort_fresh_full=det_prune)
                        elif det_prune:
                            feat["det"], anchor["det"] = banks.cold_layout(
                                cfg, det_cls.max(dim=-1).values, feat["det"], anchor["det"])
                    embed["det"] = det_enc(anchor["det"])
                    if refine_i + 1 > cfg.num_single_frame_decoder and has_temp:
                        tembed["det"] = embed["det"][:, :det_live[0]]

                    # ---- map -------------------------------------------------
                    anchor["map"], map_cls = getattr(self, f"map_refine_{refine_i}")(
                        feat["map"], anchor["map"], embed["map"])
                    out["map"]["prediction"].append(anchor["map"])
                    out["map"]["classification"].append(map_cls)
                    embed["map"], pts_embed["map"] = encode("map", anchor["map"])

                    # ---- motion ----------------------------------------------
                    if self.with_motion:
                        # [bs, n, mode, ts, 2]
                        m_anchor = self.motion_anchor[det_cls.argmax(dim=-1)]
                        m_anchor = agent_to_lidar_trajs(m_anchor, anchor["det"].detach())
                        mode_embed = sine_embed_2d(m_anchor[..., -1, :], C)
                        mode_q = self.motion_anchor_encoder_out(
                            self.motion_anchor_encoder_mlp(mode_embed))
                        motion_q = mode_q + (feat["det"] + embed["det"])[:, :, None]
                        m_cls, m_reg = getattr(self, f"motion_refine_{refine_i}")(motion_q)
                        out["motion"]["classification"].append(det_splice(m_cls, "m_cls"))
                        out["motion"]["prediction"].append(det_splice(m_reg, "m_reg"))

                    # ---- ego -------------------------------------------------
                    out["ego"]["status"].append(getattr(self, f"ego_refine_{refine_i}")(
                        feat["ego"], embed["ego"]))

                    # ---- plan ------------------------------------------------
                    plan_embed = embed["plan"]
                    if cfg.with_target_point_embed:
                        tp = sine_embed_2d(metas["target_point"], C)
                        plan_embed = plan_embed + self.target_point_encoder_out(
                            self.target_point_encoder_mlp(tp))[:, None]
                    if cfg.with_command_embed:
                        cmd = metas["gt_ego_fut_cmd"].float()
                        plan_embed = plan_embed + self.command_encoder_out(
                            self.command_encoder_mlp(cmd))[:, None]
                    if cfg.with_ego_instance_feature:
                        feat["plan"] = feat["plan"] + feat["ego"]
                        plan_embed = plan_embed + embed["ego"]
                    plan_reg, plan_cls = getattr(self, f"plan_refine_{refine_i}")(
                        feat["plan"], anchor["plan"], plan_embed)
                    if cfg.with_topk_mode and cfg.topk_mode_list is not None:
                        # per-layer plan-mode top-k; even k == all modes reorders
                        # them by score, as the JAX package does every layer
                        per_prev = plan_reg.shape[1] // ng
                        k_l = min(int(cfg.topk_mode_list[refine_i]), per_prev)
                        cls_g = plan_cls.reshape(bs, ng, per_prev)
                        scores, idx = ranking.topk(cls_g, k_l)
                        if cfg.keep_topk_relative_pos:
                            idx = idx.sort(dim=-1).values
                            scores = torch.gather(cls_g, 2, idx)

                        def take(a):
                            ag = a.reshape(bs, ng, per_prev, -1)
                            return torch.gather(
                                ag, 2, idx[..., None].expand(-1, -1, -1, ag.shape[-1]))

                        plan_reg = take(plan_reg).reshape(bs, ng * k_l, -1)
                        feat["plan"] = take(feat["plan"]).reshape(bs, ng * k_l, -1)
                        plan_cls = scores.reshape(bs, ng * k_l, 1)
                    anchor["plan"] = plan_reg
                    wp = plan_reg.reshape(bs, -1, cfg.ego_fut_ts, 2)
                    offsets = torch.cat([wp[..., :1, :], wp[..., 1:, :] - wp[..., :-1, :]], dim=-2)
                    # [bs, 1, N, ts, 2]
                    out["plan"]["prediction"].append(pad_modes(offsets, 1e6)[:, None])
                    out["plan"]["classification"].append(
                        pad_modes(plan_cls.reshape(bs, -1, 1), -1e9).reshape(bs, 1, -1))
                    embed["plan"], pts_embed["plan"] = encode("plan", anchor["plan"])

                    # ---- det-query pruning, at the end of the refine block -----
                    if det_prune and refine_i + 1 >= cfg.num_single_frame_decoder:
                        cur_t, cur_f = det_live
                        k = min(int(cfg.topk_det_list[refine_i]), cur_t + cur_f)
                        tk = k * nt // nd
                        nk = k - tk
                        if tk < cur_t or nk < cur_f:
                            new_vals = {"prediction": anchor["det"], "classification": det_cls,
                                        "quality": det_qt, "feat": feat["det"]}
                            if self.with_motion:
                                new_vals.update(m_cls=m_cls, m_reg=m_reg)
                            for key, full in new_vals.items():
                                tail_t, tail_f = full[:, tk:cur_t], full[:, cur_t + nk:]
                                if key in det_tails:
                                    # newly dropped rows precede earlier drops
                                    tail_t = torch.cat([tail_t, det_tails[key][0]], dim=1)
                                    tail_f = torch.cat([tail_f, det_tails[key][1]], dim=1)
                                det_tails[key] = (tail_t, tail_f)

                            def keep(x):
                                return torch.cat([x[:, :tk], x[:, cur_t:cur_t + nk]], dim=1)

                            feat["det"], anchor["det"], embed["det"] = (
                                keep(feat["det"]), keep(anchor["det"]), keep(embed["det"]))
                            if has_temp:
                                tfeat["det"] = tfeat["det"][:, :tk]
                                tembed["det"] = tembed["det"][:, :tk]
                            det_live = (tk, nk)
                    refine_i += 1

        # pruned plan modes padded back to the full count before caching
        feat["plan"] = pad_modes(feat["plan"], 0.0)
        anchor["plan"] = pad_modes(anchor["plan"], 1e6)
        plan_cls = pad_modes(plan_cls.reshape(bs, -1, 1), -1e9)

        with span("decoder.bank_cache"):
            # ---- cache banks for the next frame ------------------------------
            # under det pruning, at the full slot layout: live rows + frozen tails
            det_cls_full = det_splice(det_cls, "classification")
            new_det_state, temp_conf = banks.det_bank_cache(
                cfg, det_bank_state.confidence if has_temp else None,
                det_splice(feat["det"], "feat"), det_splice(anchor["det"], "prediction"),
                det_cls_full, timestamp, metas["T_global"])
            instance_id, new_det_state = banks.det_assign_instance_ids(
                cfg, det_bank_state, new_det_state, temp_conf, det_cls_full)
            new_bank_states = banks.BankStates(
                det=new_det_state,
                ego=banks.ego_bank_cache(feat["ego"], anchor["ego"], timestamp),
                plan=banks.plan_bank_cache(
                    cfg, bank_states.plan.confidence if has_temp else None,
                    feat["plan"], anchor["plan"], plan_cls, timestamp),
            )

        outputs: Dict[str, Any] = {
            "det": {
                "classification": torch.stack(out["det"]["classification"]),
                "prediction": torch.stack(out["det"]["prediction"]),
                "quality": torch.stack(out["det"]["quality"]),
                "instance_id": instance_id,
            },
            "map": {
                "classification": torch.stack(out["map"]["classification"]),
                "prediction": torch.stack(out["map"]["prediction"]),
            },
            "ego": {"status": torch.stack(out["ego"]["status"])},
            "plan": {
                "classification": torch.stack(out["plan"]["classification"]),
                "prediction": torch.stack(out["plan"]["prediction"]),
                "final_waypoints": anchor["plan"],
            },
        }
        if self.with_motion:
            outputs["motion"] = {
                "classification": torch.stack(out["motion"]["classification"]),
                "prediction": torch.stack(out["motion"]["prediction"]),
            }
        return outputs, new_bank_states
