"""3D box state layout, the box decoding and the GT box encoding
(counterpart of ``hipad_tpu/core/box3d.py``).

The undecoded 11-dim box state is

    [x, y, z, log(w), log(l), log(h), sin(yaw), cos(yaw), vx, vy, vz]

and the quality channels are (centerness, yawness). A decoded box is
``[x, y, z, w, l, h, yaw, vx, vy, vz]``.
"""

X, Y, Z, W, L, H, SIN_YAW, COS_YAW, VX, VY, VZ = range(11)
STATE_DIM = 11

# Quality indices.
CNS, YNS = 0, 1

# Decoded box: yaw angle index.
YAW = 6


def decode_box(box):
    """Undecoded 11-dim state -> decoded 10-dim box: sizes exponentiated,
    (sin, cos) collapsed to an angle."""
    import torch

    yaw = torch.atan2(box[..., SIN_YAW], box[..., COS_YAW])
    return torch.cat([box[..., X:Z + 1], torch.exp(box[..., W:H + 1]), yaw[..., None],
                      box[..., VX:]], dim=-1)


def encode_box(box):
    """Decoded GT boxes ``[..., x, y, z, w, l, h, yaw, (vel...)]`` -> the
    training target ``[x, y, z, log w, log l, log h, sin, cos, vel...]``."""
    import torch

    return torch.cat([
        box[..., 0:3],
        torch.log(torch.clamp(box[..., 3:6], min=1e-12)),
        torch.sin(box[..., YAW])[..., None],
        torch.cos(box[..., YAW])[..., None],
        box[..., YAW + 1:],
    ], dim=-1)


def box3d_to_corners(box3d):
    """Decoded boxes ``[..., >=7]`` (a tensor, or an array, which is taken in
    float32 as the JAX package takes it) -> 8 corners ``[..., 8, 3]``.

    The corner order is the JAX package's: ``unravel_index(arange(8),
    (2, 2, 2))`` reordered by ``[0, 1, 3, 2, 4, 5, 7, 6]``, centred at the
    box origin; the sizes scale the unit corners, the yaw rotates them about
    z and the centre moves them."""
    import numpy as np
    import torch

    box = box3d if torch.is_tensor(box3d) else torch.as_tensor(np.asarray(box3d, np.float32))
    unit = np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1)
    unit = torch.as_tensor(unit[[0, 1, 3, 2, 4, 5, 7, 6]].astype(np.float32) - 0.5,
                           dtype=box.dtype, device=box.device)  # [8, 3]
    corners = box[..., None, 3:6] * unit  # [..., 8, 3]
    cos, sin = torch.cos(box[..., YAW]), torch.sin(box[..., YAW])
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack([torch.stack([cos, -sin, zeros], dim=-1),
                       torch.stack([sin, cos, zeros], dim=-1),
                       torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)  # [..., 3, 3]
    corners = torch.einsum("...ij,...kj->...ki", rot, corners)
    return corners + box[..., None, 0:3]
