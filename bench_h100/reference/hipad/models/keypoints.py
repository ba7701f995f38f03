# Frozen copy of hipad_torch/models/keypoints.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Keypoint generators: anchors -> 3D sampling points (counterparts of
``hipad_tpu/models/keypoints.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.box3d import COS_YAW, SIN_YAW, W, X
from ..core.geometry import fp32, yaw_rotation_2d


class BoxKeypoints(nn.Module):
    """Box-frame fixed-scale points plus learnable offsets (sigmoid - 0.5 of a
    linear head), scaled by the box size, rotated by yaw, moved to the box
    centre. The offsets are a function of the ANCHOR EMBED (see
    ``DeformableAggregation.prepare``)."""

    def __init__(self, spec, embed_dims: int):
        super().__init__()
        self.num_learnable = spec.num_learnable
        self.num_pts = len(spec.fix_scale) + spec.num_learnable
        self.register_buffer("fix_scale", torch.as_tensor(
            np.array(spec.fix_scale, np.float32)), persistent=False)
        self.learnable_fc = (nn.Linear(embed_dims, spec.num_learnable * 3)
                             if spec.num_learnable > 0 else None)

    def forward(self, anchor: torch.Tensor, instance_feature: torch.Tensor) -> torch.Tensor:
        bs, n = anchor.shape[:2]
        size = torch.exp(anchor[..., None, W:W + 3])  # [bs, n, 1, 3]
        pts = self.fix_scale * size
        if self.learnable_fc is not None:
            offs = self.learnable_fc(instance_feature).reshape(bs, n, self.num_learnable, 3)
            pts = torch.cat([pts, (torch.sigmoid(offs) - 0.5) * size], dim=-2)
        return _rotate_translate(pts, anchor)


@fp32
def _rotate_translate(pts: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """Box-frame points [bs, n, P, 3] -> rotated by each anchor's yaw and
    moved to its centre."""
    rot2 = yaw_rotation_2d(anchor[..., SIN_YAW], anchor[..., COS_YAW])
    xy = torch.einsum("bnij,bnpj->bnpi", rot2, pts[..., :2])
    return torch.cat([xy, pts[..., 2:3]], dim=-1) + anchor[..., None, X:X + 3]


class PointKeypoints(nn.Module):
    """Polyline keypoints: each of the anchor's ``num_sample`` 2D points
    spawns ``len(fix_height) * num_learnable`` points with learnable 2D
    offsets and z = ground_height + fix_height."""

    def __init__(self, spec, embed_dims: int):
        super().__init__()
        self.spec = spec
        nh, nl = len(spec.fix_height), spec.num_learnable
        self.num_pts = spec.num_sample * nh * nl
        self.register_buffer("fix_height", torch.as_tensor(
            np.array(spec.fix_height, np.float32)), persistent=False)
        self.learnable_fc = nn.Linear(embed_dims, spec.num_sample * nh * nl * 2)

    def forward(self, anchor: torch.Tensor, instance_feature: torch.Tensor) -> torch.Tensor:
        bs, n = anchor.shape[:2]
        s = self.spec
        nh, nl = len(s.fix_height), s.num_learnable
        base = anchor.reshape(bs, n, s.num_sample, 2)
        offs = self.learnable_fc(instance_feature).reshape(bs, n, s.num_sample, nh, nl, 2)
        xy = offs + base[:, :, :, None, None, :]
        z = (s.ground_height + self.fix_height)[:, None, None].expand(xy.shape[:-1] + (1,))
        pts = torch.cat([xy, z.to(xy.dtype)], dim=-1)
        return pts.reshape(bs, n, self.num_pts, 3)
