# Frozen copy of hipad_torch/agent/calib.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""CARLA sensor-rig calibration, computed from the rig geometry.

The reference hardcodes LIDAR2IMG / LIDAR2CAM / CAM2IMG / LIDAR2EGO tables
(`hipad_b2d_agent.py:39-138`). We derive them from the declared sensor rig
(`hipad_b2d_agent.py:162-239`: 6 RGB cameras at 1600x900, fov 70 except the
110-degree back camera); tests pin entries against the reference's published
numbers to guarantee the same projection.

Frames:
  * lidar (model frame): x right, y forward, z up (nuScenes-style);
  * ego: right-handed x forward / y LEFT / z up — CARLA's left-handed pose is
    converted by flipping y and negating yaw (the agent does the same with
    ``pos = [x, -y]`` and ``ego_theta = -compass + pi/2``);
  * camera: x right, y down, z forward.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# (x, y, z, yaw_deg, fov) in CARLA's frame (`hipad_b2d_agent.py:162-239`).
CAMERA_RIG = {
    "CAM_FRONT": (0.80, 0.0, 1.60, 0.0, 70),
    "CAM_FRONT_LEFT": (0.27, -0.55, 1.60, -55.0, 70),
    "CAM_FRONT_RIGHT": (0.27, 0.55, 1.60, 55.0, 70),
    "CAM_BACK": (-2.0, 0.0, 1.60, 180.0, 110),
    "CAM_BACK_LEFT": (-0.32, -0.55, 1.60, -110.0, 70),
    "CAM_BACK_RIGHT": (-0.32, 0.55, 1.60, 110.0, 70),
}
CAMERAS = list(CAMERA_RIG)
IMG_W, IMG_H = 1600, 900

# lidar -> ego (`hipad_b2d_agent.py:135-138`): ego_x = lidar_y - 0.39,
# ego_y = -lidar_x, ego_z = lidar_z + 1.84.
LIDAR2EGO = np.array(
    [[0.0, 1.0, 0.0, -0.39],
     [-1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 1.0, 1.84],
     [0.0, 0.0, 0.0, 1.0]]
)


def intrinsic(fov_deg: float, w: int = IMG_W, h: int = IMG_H) -> np.ndarray:
    f = w / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    k = np.eye(4)
    k[0, 0] = k[1, 1] = f
    k[0, 2] = w / 2.0
    k[1, 2] = h / 2.0
    return k


def ego2cam(x_carla: float, y_carla: float, z: float, yaw_carla_deg: float) -> np.ndarray:
    """Ego frame (x fwd / y left / z up) -> camera (x right / y down / z fwd)."""
    t = np.array([x_carla, -y_carla, z])  # CARLA y-right -> ego y-left
    yaw = np.radians(-yaw_carla_deg)  # left-handed -> right-handed
    fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    rot = np.stack([right, down, fwd])  # rows: world->cam
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ t
    return m


def lidar2cam_matrices() -> Dict[str, np.ndarray]:
    return {
        name: ego2cam(x, y, z, yaw) @ LIDAR2EGO
        for name, (x, y, z, yaw, _) in CAMERA_RIG.items()
    }


def lidar2img_matrices() -> Dict[str, np.ndarray]:
    return {
        name: intrinsic(fov) @ ego2cam(x, y, z, yaw) @ LIDAR2EGO
        for name, (x, y, z, yaw, fov) in CAMERA_RIG.items()
    }


def stacked_lidar2img() -> np.ndarray:
    mats = lidar2img_matrices()
    return np.stack([mats[c] for c in CAMERAS]).astype(np.float32)
