# Frozen copy of hipad_torch/core/geometry.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Geometry on tensors: camera projection, SE(3) anchor warps, sine embeds.

Counterpart of ``hipad_tpu/core/geometry.py``; same shapes and layouts.
Projections and rigid warps run in float32 even inside a bf16 autocast
region (:func:`fp32`): pixel coordinates and poses need all 24 bits.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .box3d import COS_YAW, SIN_YAW, VX, W, X


def fp32(fn):
    """Run ``fn`` with autocast off (on the card and on the CPU) and its
    floating tensor arguments in float32."""

    def cast(a):
        return a.float() if torch.is_tensor(a) and a.is_floating_point() else a

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            return fn(*map(cast, args), **{k: cast(v) for k, v in kwargs.items()})

    return wrapped


def yaw_rotation_2d(sin_yaw: torch.Tensor, cos_yaw: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] rotation matrices from (sin, cos) pairs."""
    row0 = torch.stack([cos_yaw, -sin_yaw], dim=-1)
    row1 = torch.stack([sin_yaw, cos_yaw], dim=-1)
    return torch.stack([row0, row1], dim=-2)


@fp32
def project_points(
    key_points: torch.Tensor,
    projection_mat: torch.Tensor,
    image_wh: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """[bs, anchor, pts, 3] lidar points -> [bs, cams, anchor, pts, 2] image
    points (normalised to [0, 1] when ``image_wh [bs, cams, 2]`` is given).

    The depth is clamped from below at ``eps``: points behind a camera map to
    huge coordinates that the sampler's bounds check masks out.
    """
    pts_h = torch.cat([key_points, torch.ones_like(key_points[..., :1])], dim=-1)
    proj = torch.einsum("bcij,bapj->bcapi", projection_mat, pts_h)
    xy = proj[..., :2] / torch.clamp(proj[..., 2:3], min=eps)
    if image_wh is not None:
        xy = xy / image_wh[:, :, None, None]
    return xy


@fp32
def box_anchor_projection(
    anchor: torch.Tensor,
    t_src2dst: torch.Tensor,
    time_interval: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Warp [bs, n, 11] box anchors by the rigid transform [bs, 4, 4].

    With ``time_interval [bs]`` the centre first moves by
    ``-velocity * time_interval`` (callers pass the negative elapsed time so
    cached boxes advance along their velocity).
    """
    vel = anchor[..., VX:]
    center = anchor[..., X:X + 3]
    if time_interval is not None:
        center = center - vel * time_interval[:, None, None]
    rot = t_src2dst[:, :3, :3]
    center = torch.einsum("bij,bnj->bni", rot, center) + t_src2dst[:, None, :3, 3]
    size = anchor[..., W:W + 3]
    # rotate the (cos, sin) direction vector, store back as (sin, cos)
    cs = torch.stack([anchor[..., COS_YAW], anchor[..., SIN_YAW]], dim=-1)
    cs = torch.einsum("bij,bnj->bni", t_src2dst[:, :2, :2], cs)
    yaw = cs.flip(-1)
    vel = torch.einsum("bij,bnj->bni", rot, vel)
    return torch.cat([center, size, yaw, vel], dim=-1)


def sine_embed_2d(pos: torch.Tensor, hidden_dim: int = 256) -> torch.Tensor:
    """DAB-DETR 2D sine embedding of [..., 2] (x, y): [..., hidden_dim] laid
    out as cat(embed_y, embed_x)."""
    half = hidden_dim // 2
    scale = 2.0 * math.pi
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / half)
    x = pos[..., 0:1] * scale / dim_t
    y = pos[..., 1:2] * scale / dim_t

    def interleave(v):
        s = torch.sin(v[..., 0::2])
        c = torch.cos(v[..., 1::2])
        return torch.stack([s, c], dim=-1).reshape(v.shape[:-1] + (half,))

    return torch.cat([interleave(y), interleave(x)], dim=-1)


def agent_to_lidar_trajs(trajs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Rotate [bs, n, mode, ts, 2] agent-frame trajectories by each box's yaw
    (boxes [bs, n, 11]) into the ego frame."""
    yaw = torch.atan2(boxes[..., SIN_YAW], boxes[..., COS_YAW])
    cos = torch.cos(yaw)[:, :, None, None]
    sin = torch.sin(yaw)[:, :, None, None]
    x = trajs[..., 0] * cos - trajs[..., 1] * sin
    y = trajs[..., 0] * sin + trajs[..., 1] * cos
    return torch.stack([x, y], dim=-1)
