# Frozen copy of hipad_torch/models/refine.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Per-task refinement / prediction heads (counterparts of
``hipad_tpu/models/refine.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..core.box3d import VX
from .common import MLP, MLPLN, Scale


class ClsHead(nn.Module):
    """MLPLN(1, 2) + Linear; the bias is focal-style initialised
    (``weights.init_random``)."""

    def __init__(self, embed_dims: int, num_cls: int):
        super().__init__()
        self.mlp = MLPLN(embed_dims, embed_dims, 1, 2)
        self.out = nn.Linear(embed_dims, num_cls)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.mlp(x))


class SparseBox3DRefinement(nn.Module):
    """Anchor delta + classification + quality."""

    def __init__(self, cfg, num_cls: int):
        super().__init__()
        d = cfg.embed_dims
        self.reg_mlp = MLPLN(d, d, 2, 2)
        self.reg_out = nn.Linear(d, 11)
        self.reg_scale = Scale(11)
        self.cls = ClsHead(d, num_cls)
        self.quality_mlp = MLPLN(d, d, 1, 2)
        self.quality_out = nn.Linear(d, 2)

    def forward(self, instance_feature, anchor, anchor_embed, time_interval):
        feature = instance_feature + anchor_embed
        out = self.reg_scale(self.reg_out(self.reg_mlp(feature)))
        delta_state = out[..., :8] + anchor[..., :8]
        # velocity: predicted translation / dt + previous velocity
        vel = out[..., VX:] / time_interval[:, None, None] + anchor[..., VX:]
        output = torch.cat([delta_state, vel], dim=-1)
        cls = self.cls(instance_feature)
        quality = self.quality_out(self.quality_mlp(feature))
        return output, cls, quality


class SparsePoint3DRefinement(nn.Module):
    """Polyline delta + classification."""

    def __init__(self, cfg, num_cls: int, out_dim: int):
        super().__init__()
        d = cfg.embed_dims
        self.reg_mlp = MLPLN(d, d, 2, 2)
        self.reg_out = nn.Linear(d, out_dim)
        self.reg_scale = Scale(out_dim)
        self.cls = ClsHead(d, num_cls)

    def forward(self, instance_feature, anchor, anchor_embed):
        out = self.reg_scale(self.reg_out(self.reg_mlp(instance_feature + anchor_embed)))
        return out + anchor, self.cls(instance_feature)


class EgoStatusRefinement(nn.Module):
    """Ego-status MLP head."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.embed_dims
        self.status = MLP(d, (d, d, cfg.ego_status_dims))

    def forward(self, ego_feature, ego_anchor_embed):
        return self.status(ego_feature + ego_anchor_embed)


class SparseMotionRefinement(nn.Module):
    """Per-agent multi-mode trajectory head."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.embed_dims
        self.fut_mode, self.fut_ts = cfg.fut_mode, cfg.fut_ts
        self.cls = ClsHead(d, 1)
        self.reg = MLP(d, (d, d, cfg.fut_ts * 2))

    def forward(self, motion_query):
        bs, n = motion_query.shape[:2]
        cls = self.cls(motion_query).squeeze(-1)
        reg = self.reg(motion_query)
        return cls, reg.reshape(bs, n, self.fut_mode, self.fut_ts, 2)


class SparsePlanAlignRefinement(nn.Module):
    """Multi-granularity planning head: the query holds ``anchor_group``
    blocks of cmd*mode queries; temp/spat blocks sum into one align query,
    each speed bucket (summed over frequencies) adds on top of it. Each
    (kind, unit) owns a reg branch; temp/spat share ``cls``, speed types
    share ``cls_speed``."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.embed_dims
        self.types = cfg.plan_anchor_types
        self.speed_areas = list(cfg.speed_areas)
        self.has_speed = any(t[0] not in ("temp", "spat") for t in self.types)
        self.cls = ClsHead(d, 1)
        self.cls_speed = ClsHead(d, 1) if self.has_speed else None
        for t in self.types:
            key = f"reg_{t[0]}_{t[1]}"
            if not hasattr(self, key + "_mlp"):
                self.add_module(key + "_mlp", MLPLN(d, d, 2, 2))
                self.add_module(key + "_out", nn.Linear(d, cfg.ego_fut_ts * 2))
                self.add_module(key + "_scale", Scale(cfg.ego_fut_ts * 2))

    def forward(self, instance_feature, anchor, anchor_embed):
        per = instance_feature.shape[1] // len(self.types)
        x = instance_feature + anchor_embed
        blocks = [x[:, i * per:(i + 1) * per] for i in range(len(self.types))]

        align_query = None
        speed_by_freq: dict = {}
        for t, blk in zip(self.types, blocks):
            if t[0] in ("temp", "spat"):
                align_query = blk if align_query is None else align_query + blk
            else:
                speed_by_freq.setdefault(t[1], [None] * len(self.speed_areas))
                speed_by_freq[t[1]][self.speed_areas.index(t[2])] = blk
        speed_query = {}
        for si in range(len(self.speed_areas) if speed_by_freq else 0):
            q = sum(v[si] for v in speed_by_freq.values())
            speed_query[si] = align_query + q

        cls_outs, reg_outs = [], []
        for t in self.types:
            if t[0] in ("temp", "spat"):
                q = align_query
                cls_outs.append(self.cls(q))
            else:
                q = speed_query[self.speed_areas.index(t[2])]
                cls_outs.append(self.cls_speed(q))
            key = f"reg_{t[0]}_{t[1]}"
            mlp, dense, scale = (getattr(self, key + s) for s in ("_mlp", "_out", "_scale"))
            reg_outs.append(scale(dense(mlp(q))))
        return torch.cat(reg_outs, dim=1) + anchor, torch.cat(cls_outs, dim=1)
