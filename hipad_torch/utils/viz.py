"""Visualization helpers: 3D boxes / polylines / trajectories on camera and
BEV canvases (counterpart of `datasets/utils.py:10-246` and the agent's
composite dumps `hipad_b2d_agent.py:617-750`). Pure numpy; PIL only for
encoding."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..core.box3d import box3d_to_corners

# BGR-ish palette per det class id
PALETTE = np.array([
    (66, 135, 245), (245, 130, 66), (66, 245, 141), (245, 66, 227),
    (245, 245, 66), (66, 245, 245), (181, 66, 245), (245, 66, 66),
    (160, 160, 160),
], np.uint8)

_EDGES = ((0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7))


def _line(img: np.ndarray, p0, p1, color, thickness: int = 1):
    """Bresenham-ish line draw (no cv2 dependency)."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    for t in range(-(thickness // 2), thickness // 2 + 1):
        m = (xs >= 0) & (xs < w) & (ys + t >= 0) & (ys + t < h)
        img[ys[m] + t, xs[m]] = color
        m = (xs + t >= 0) & (xs + t < w) & (ys >= 0) & (ys < h)
        img[ys[m], xs[m] + t] = color


def draw_boxes_on_image(
    img: np.ndarray,
    boxes_3d: np.ndarray,
    lidar2img: np.ndarray,
    labels: Optional[np.ndarray] = None,
    thickness: int = 1,
) -> np.ndarray:
    """Project decoded boxes into one camera and draw wireframes.

    Args: img [H, W, 3] uint8; boxes_3d [N, >=7]; lidar2img [4, 4].
    """
    img = img.copy()
    if len(boxes_3d) == 0:
        return img
    corners = np.asarray(box3d_to_corners(boxes_3d))  # [N, 8, 3]
    n = len(corners)
    pts = np.concatenate([corners.reshape(-1, 3),
                          np.ones((n * 8, 1))], axis=1)
    proj = (lidar2img @ pts.T).T
    z = proj[:, 2]
    uv = proj[:, :2] / np.maximum(z[:, None], 1e-5)
    uv = uv.reshape(n, 8, 2)
    z = z.reshape(n, 8)
    for i in range(n):
        color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None else PALETTE[0]
        for a, b in _EDGES:
            if z[i, a] > 0.1 and z[i, b] > 0.1:
                _line(img, uv[i, a], uv[i, b], color, thickness)
    return img


class BEVCanvas:
    """Ego-centred BEV raster: x right, y up (forward)."""

    def __init__(self, size: int = 512, range_m: float = 50.0):
        self.size = size
        self.range = range_m
        self.img = np.full((size, size, 3), 20, np.uint8)

    def to_px(self, xy: np.ndarray) -> np.ndarray:
        s = self.size / (2 * self.range)
        px = self.size / 2 + xy[..., 0] * s
        py = self.size / 2 - xy[..., 1] * s
        return np.stack([px, py], axis=-1)

    def draw_polyline(self, pts_xy: np.ndarray, color, thickness: int = 1):
        px = self.to_px(np.asarray(pts_xy))
        for a, b in zip(px[:-1], px[1:]):
            _line(self.img, a, b, color, thickness)

    def draw_boxes(self, boxes_3d: np.ndarray, labels=None, thickness: int = 1):
        if len(boxes_3d) == 0:
            return
        corners = np.asarray(box3d_to_corners(boxes_3d))[:, [0, 3, 7, 4], :2]
        for i, c in enumerate(corners):
            color = PALETTE[int(labels[i]) % len(PALETTE)] if labels is not None else PALETTE[0]
            loop = np.concatenate([c, c[:1]])
            self.draw_polyline(loop, color, thickness)

    def draw_ego(self, size=(1.84, 4.89)):
        w, l = size
        box = np.array([[0, 0.5, 0, w, l, 1.5, np.pi / 2]])
        self.draw_boxes(box, labels=np.array([7]), thickness=2)


def render_frame(result: Dict, gt_boxes: Optional[np.ndarray] = None,
                 size: int = 512) -> np.ndarray:
    """Composite BEV of one post-processed frame: detections (top-50), map
    vectors, selected plan trajectories, ego box."""
    bev = BEVCanvas(size)
    bev.draw_ego()
    if "boxes_3d" in result:
        keep = np.asarray(result["scores_3d"]) > 0.3
        bev.draw_boxes(np.asarray(result["boxes_3d"])[keep][:50],
                       np.asarray(result["labels_3d"])[keep][:50])
    if "vectors" in result:
        keep = np.asarray(result["scores"]) > 0.3
        for vec, lab in zip(np.asarray(result["vectors"])[keep][:30],
                            np.asarray(result["labels"])[keep][:30]):
            bev.draw_polyline(vec, PALETTE[(lab + 3) % len(PALETTE)])
    for key, color in (("plan_temp_2hz", (0, 255, 0)), ("plan_spat_2m", (0, 180, 255)),
                       ("plan_speed_5hz", (255, 80, 80))):
        if key in result:
            traj = np.asarray(result[key])
            bev.draw_polyline(np.concatenate([np.zeros((1, 2)), traj]),
                              np.array(color, np.uint8), thickness=2)
    if gt_boxes is not None and len(gt_boxes):
        bev.draw_boxes(gt_boxes, labels=np.full(len(gt_boxes), 8))
    return bev.img


def _draw_circle(img: np.ndarray, center, radius: int, color):
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for t in np.linspace(0, 2 * np.pi, 8 * radius + 8):
        x, y = int(cx + radius * np.cos(t)), int(cy + radius * np.sin(t))
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _project_traj(traj_xy: np.ndarray, lidar2img: np.ndarray,
                  z: float = -1.8) -> np.ndarray:
    """Ground-plane waypoints -> (image points [n, 2], in-front mask [n])
    (`hipad_b2d_agent.py:646-663`)."""
    n = len(traj_xy)
    pts = np.concatenate([traj_xy, np.full((n, 1), z), np.ones((n, 1))], axis=1)
    proj = (lidar2img @ pts.T).T
    keep = proj[:, 2] > 1e-5
    uv = proj[:, :2] / np.where(keep, proj[:, 2], 1.0)[:, None]
    return uv, keep


def render_composite(
    cam_images: Dict[str, np.ndarray],
    lidar2imgs: Dict[str, np.ndarray],
    result: Dict,
    target_point: Optional[np.ndarray] = None,
    cam_order=("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
               "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT"),
) -> np.ndarray:
    """Reference-style composite dump (`hipad_b2d_agent.py:617-750`): a 2x3
    multi-camera mosaic (detections on every camera; selected plan
    trajectories + target point on the three front cameras) with the BEV
    panel on the right. Pure numpy/PIL — no cv2."""
    front_cams = {"CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT"}
    tiles = []
    boxes = np.asarray(result.get("boxes_3d", np.zeros((0, 9))))
    labels = np.asarray(result.get("labels_3d", np.zeros((0,), int)))
    scores = np.asarray(result.get("scores_3d", np.zeros((0,))))
    keep = scores > 0.3
    boxes, labels = boxes[keep][:50], labels[keep][:50]

    for cam in cam_order:
        img = cam_images[cam].copy()
        l2i = lidar2imgs[cam]
        img = draw_boxes_on_image(img, boxes, l2i, labels)
        if cam in front_cams:
            for key, color in (("plan_spat_2m", (0, 200, 255)),
                               ("plan_speed_5hz", (255, 0, 0))):
                if key in result:
                    traj = np.concatenate(
                        [np.zeros((1, 2)), np.asarray(result[key])])
                    uv, kp = _project_traj(traj, l2i)
                    # only join ADJACENT in-front waypoints: a behind-camera
                    # point breaks the polyline rather than bridging across
                    for i in range(len(uv) - 1):
                        if kp[i] and kp[i + 1]:
                            _line(img, uv[i], uv[i + 1],
                                  np.array(color, np.uint8), 3)
            if target_point is not None:
                uv, kp = _project_traj(np.asarray(target_point)[None], l2i)
                if kp[0]:
                    _draw_circle(img, uv[0], 7, np.array((255, 105, 120),
                                                         np.uint8))
        tiles.append(img)

    h, w = tiles[0].shape[:2]
    line1 = np.hstack(tiles[:3])
    line2 = np.hstack(tiles[3:])
    mosaic = np.vstack([line1, line2])
    bev = render_frame(result, size=2 * h)
    if target_point is not None:
        canvas = BEVCanvas(2 * h)
        px = canvas.to_px(np.asarray(target_point, np.float64))
        _draw_circle(bev, px, 4, np.array((255, 105, 120), np.uint8))
    return np.hstack([mosaic, bev])
