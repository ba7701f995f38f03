"""The general traffic generator: every mix is a data file under
``traffic/`` whose ``kind`` names one of the generators here and whose
other keys are their parameters. The same seed gives the same inputs; every
seed gives the same sizes, so seeds change the content and not the work.

* camera-like frames (:func:`camera_frames`): sky and road gradients, a few
  dozen filled boxes and ellipses, mild sensor noise; made on the device in
  a few large calls and brought to the host as uint8, as a simulator or a
  recorded split hands them over;
* a 2 Hz stream of frames along a circular route with the CARLA rig's
  calibration at the configuration's input size (:class:`StreamFrames`,
  :func:`rig_aug`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference.hipad.agent.calib import LIDAR2EGO, stacked_lidar2img
from ..reference.hipad.data import pipelines as pp

TRAFFIC_STREAM = 0x7AFF  # keeps the traffic's draws apart from the weights'


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 2 + TRAFFIC_STREAM)


def camera_frames(n: int, h: int, w: int, shapes: int, noise: float,
                  gen: torch.Generator, device) -> torch.Tensor:
    """``n`` camera-like RGB frames -> uint8 ``[n, h, w, 3]`` on ``device``."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    ys = torch.linspace(0.0, 1.0, h, device=device)[None, :, None, None]
    xs = torch.linspace(0.0, 1.0, w, device=device)[None, None, :, None]
    horizon = u(n, 1, 1, 1, lo=0.4, hi=0.6)
    sky_top, sky_low = u(n, 1, 1, 3, lo=90, hi=200), u(n, 1, 1, 3, lo=150, hi=250)
    road_near, road_far = u(n, 1, 1, 3, lo=40, hi=110), u(n, 1, 1, 3, lo=90, hi=160)
    t_sky = (ys / horizon).clamp(0, 1)
    t_road = ((ys - horizon) / (1 - horizon)).clamp(0, 1)
    img = torch.where(ys < horizon, sky_top + (sky_low - sky_top) * t_sky,
                      road_far + (road_near - road_far) * t_road)
    img = img + 12.0 * (xs - 0.5) * u(n, 1, 1, 1, lo=-1, hi=1)
    cx, cy = u(shapes, n, lo=0.0, hi=1.0), u(shapes, n, lo=0.25, hi=0.95)
    rx, ry = u(shapes, n, lo=0.01, hi=0.12), u(shapes, n, lo=0.01, hi=0.15)
    color = u(shapes, n, 3, lo=0, hi=255)
    ellipse = u(shapes, n) < 0.4
    for k in range(shapes):  # later shapes cover earlier ones
        dx = (xs - cx[k].view(n, 1, 1, 1)) / rx[k].view(n, 1, 1, 1)
        dy = (ys - cy[k].view(n, 1, 1, 1)) / ry[k].view(n, 1, 1, 1)
        box = (dx.abs() <= 1) & (dy.abs() <= 1)
        inside = torch.where(ellipse[k].view(n, 1, 1, 1), dx * dx + dy * dy <= 1, box)
        img = torch.where(inside, color[k].view(n, 1, 1, 3), img)
    img = img + noise * torch.randn(img.shape, generator=gen, device=device)
    return img.round().clamp(0, 255).to(torch.uint8)


def rig_aug(cfg) -> Dict:
    """The rig's test-time augmentation for images of the configuration's
    ``input_size`` (H, W): the 1600x900 camera resized by max(H/900, W/1600)
    and cropped centred in width and from the bottom, as the reference's
    test pipeline does for any ``final_dim``."""
    return pp.sample_aug_config(dict(pp.DATA_AUG_CONF, final_dim=tuple(cfg.input_size)),
                                test_mode=True)


class StreamFrames:
    """Recorded frames streamed at 2 Hz: ``frame(i)`` is the ``i``-th
    frame's (normalised float32 images ``[bs, cams, H, W, 3]`` on the host,
    pinned; metas as numpy). The images come in turn from a pool made at
    set-up; the ego drives a circle at a constant speed from an angle drawn
    from the seed, the cameras are the CARLA rig's at the test-time resize
    and crop for the configuration's own input size (as the reference's
    test pipeline makes them for any ``final_dim``), the command is
    LANEFOLLOW and the target point lies on the circle ahead."""

    def __init__(self, params: Dict, cfg, seed: int, device):
        gen = generator(seed, device)
        bs, h, w = params["batch"], cfg.input_size[0], cfg.input_size[1]
        cam = params["cameras"]
        n = cam["pool"] * bs * cfg.num_cams
        u8 = camera_frames(n, h, w, cam["shapes"], cam["noise"], gen, device)
        mean = torch.as_tensor(pp.IMG_MEAN, device=device)
        std = torch.as_tensor(pp.IMG_STD, device=device)
        imgs = ((u8.float() - mean) / std).view(cam["pool"], bs, cfg.num_cams, h, w, 3).cpu()
        self.pool = imgs.pin_memory() if torch.cuda.is_available() else imgs
        r = params["route"]
        self.radius, self.speed, self.dt = r["radius"], r["speed"], params["frame_dt_s"]
        self.theta0 = 2 * math.pi * float(torch.rand((), generator=gen, device=device))
        self.target_ahead = r["target_ahead_m"]
        aug = rig_aug(cfg)
        self.lidar2img = (pp.img_transform_matrix(aug)[None] @ stacked_lidar2img()
                          ).astype(np.float32)
        self.bs, self.num_cams, self.wh = bs, cfg.num_cams, (w, h)
        self.num_command = cfg.num_command
        self.focal = np.float32(aug["resize"] * 1600 / (2 * math.tan(math.radians(35))))

    def pose(self, i: int):
        """Ego position (x, y) and heading on the circle at frame ``i``."""
        theta = self.theta0 + self.speed * self.dt * i / self.radius
        pos = self.radius * np.array([math.cos(theta), math.sin(theta)])
        return pos, theta + math.pi / 2

    def frame(self, i: int):
        bs = self.bs
        pos, heading = self.pose(i)
        ego2world = np.eye(4)
        c, s = math.cos(heading), math.sin(heading)
        ego2world[:2, :2] = [[c, -s], [s, c]]
        ego2world[:2, 3] = pos
        lidar2global = (ego2world @ LIDAR2EGO).astype(np.float32)
        ahead = self.target_ahead / self.radius
        tgt = self.radius * np.array([math.cos(self.theta0 + self.speed * self.dt * i
                                               / self.radius + ahead),
                                      math.sin(self.theta0 + self.speed * self.dt * i
                                               / self.radius + ahead)])
        rot = np.array([[c, s], [-s, c]])  # world -> ego
        target_point = (rot @ (tgt - pos)).astype(np.float32)
        cmd = np.zeros((bs, self.num_command), np.float32)
        cmd[:, 3] = 1.0  # LANEFOLLOW, command 4
        metas = {
            "timestamp": np.full((bs,), i * self.dt, np.float32),
            "projection_mat": np.broadcast_to(self.lidar2img, (bs,) + self.lidar2img.shape).copy(),
            "image_wh": np.tile(np.array(self.wh, np.float32), (bs, self.num_cams, 1)),
            "T_global": np.broadcast_to(lidar2global, (bs, 4, 4)).copy(),
            "T_global_inv": np.broadcast_to(np.linalg.inv(lidar2global).astype(np.float32),
                                            (bs, 4, 4)).copy(),
            "target_point": np.broadcast_to(target_point, (bs, 2)).copy(),
            "gt_ego_fut_cmd": cmd,
            "focal": np.full((bs, self.num_cams), self.focal, np.float32),
        }
        return self.pool[i % len(self.pool)], metas
