"""Anchor encoders: box / polyline state -> query positional embeddings
(counterparts of ``hipad_tpu/models/encoders.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..core.box3d import COS_YAW, SIN_YAW, VX, W, X
from .common import MLPLN


class SparseBox3DEncoder(nn.Module):
    """Decoupled box encoder: separate MLP+LN stacks for position / size /
    yaw / velocity, concatenated (128 + 32 + 32 + 64 = 256 at C=256)."""

    def __init__(self, embed_dims: tuple = (128, 32, 32, 64), out_loops: int = 4):
        super().__init__()
        self.pos_fc = MLPLN(3, embed_dims[0], 1, out_loops)
        self.size_fc = MLPLN(3, embed_dims[1], 1, out_loops)
        self.yaw_fc = MLPLN(2, embed_dims[2], 1, out_loops)
        self.vel_fc = MLPLN(3, embed_dims[3], 1, out_loops)

    def forward(self, box: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.pos_fc(box[..., X:X + 3]),
            self.size_fc(box[..., W:W + 3]),
            self.yaw_fc(box[..., SIN_YAW:COS_YAW + 1]),  # adjacent: a slice, no list index
            self.vel_fc(box[..., VX:VX + 3]),
        ], dim=-1)


class SparsePoint3DEncoder(nn.Module):
    """Flattened-polyline encoder."""

    def __init__(self, in_dims: int, embed_dims: int = 256):
        super().__init__()
        self.pos_fc = MLPLN(in_dims, embed_dims, 1, 2)

    def forward(self, anchor: torch.Tensor) -> torch.Tensor:
        return self.pos_fc(anchor)


class KeyPoint3DEncoder(nn.Module):
    """Per-point and instance polyline encoder: with point-expanded map or
    plan queries (``with_concat_*_points``, ``with_deform_*_points``) it
    takes the place of :class:`SparsePoint3DEncoder` and returns both the
    instance embedding ``[bs, n, C]`` (``embed_instance``) and a per-point
    embedding ``[bs, n * num_sample, C]`` of each point's (x, y)
    (``embed_points``)."""

    def __init__(self, embed_dims: int = 256, num_sample: int = 6):
        super().__init__()
        self.num_sample = num_sample
        self.embed_points = MLPLN(2, embed_dims, 1, 2)
        self.embed_instance = MLPLN(num_sample * 2, embed_dims, 1, 2)

    def forward(self, anchor: torch.Tensor):
        bs, n = anchor.shape[:2]
        pts = anchor.reshape(bs, n * self.num_sample, 2)
        return self.embed_instance(anchor), self.embed_points(pts)
