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
