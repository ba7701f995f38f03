# Frozen copy of hipad_torch/data/pipelines.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Per-frame data pipeline (pure numpy, host-side).

TPU rework of `datasets/pipelines/{loading,augment,transform,vectorize}.py`:
the same augmentation and adaptor math, but emitting *fixed-capacity padded*
GT arrays with validity masks (static shapes for jit) instead of ragged
tensors/DataContainers.

Image convention: the reference loads BGR uint8 (mmcv), distorts in BGR/HSV,
then `NormalizeMultiviewImage(to_rgb=True)` converts to RGB and standardises
(`transform.py:285-321`). We keep identical numerics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)  # RGB
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)

# Fixed GT capacities (TPU static shapes). 55 m circle filter + B2D traffic
# densities keep per-frame counts well under these.
MAX_GT_BOXES = 64
MAX_GT_MAP = 48

DATA_AUG_CONF = {  # stage2 config:593-602
    "resize_lim": (0.40, 0.47),
    "final_dim": (352, 640),  # (H, W)
    "bot_pct_lim": (0.0, 0.0),
    "rot_lim": (-5.4, 5.4),
    "H": 900,
    "W": 1600,
    "rand_flip": True,
    "rot3d_range": (0.0, 0.0),
}


# --------------------------------------------------------------------------
# Augmentation config sampling (`bench2drive_dataset.py:709-757`)
# --------------------------------------------------------------------------

def sample_aug_config(
    conf: Dict = DATA_AUG_CONF, rng: Optional[np.random.RandomState] = None,
    test_mode: bool = False,
) -> Dict:
    rng = rng or np.random.RandomState()
    H, W = conf["H"], conf["W"]
    fH, fW = conf["final_dim"]
    if not test_mode:
        resize = rng.uniform(*conf["resize_lim"])
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*conf["bot_pct_lim"])) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(conf["rand_flip"] and rng.choice([0, 1]))
        rotate = rng.uniform(*conf["rot_lim"])
        rotate_3d = rng.uniform(*conf["rot3d_range"])
    else:
        resize = max(fH / H, fW / W)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(conf["bot_pct_lim"])) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip, rotate, rotate_3d = False, 0.0, 0.0
    return {
        "resize": resize, "resize_dims": (newW, newH), "crop": crop,
        "flip": flip, "rotate": rotate, "rotate_3d": rotate_3d,
    }


# --------------------------------------------------------------------------
# Image resize/crop/flip/rotate + projection update (`augment.py:46-92`)
# --------------------------------------------------------------------------

def img_transform_matrix(aug: Dict) -> np.ndarray:
    """4x4 image-plane transform matching the PIL op sequence."""
    resize = aug.get("resize", 1.0)
    crop = aug.get("crop")
    flip = aug.get("flip", False)
    rotate = aug.get("rotate", 0.0)
    m = np.eye(3)
    m[:2, :2] *= resize
    if crop is not None:
        m[:2, 2] -= np.array(crop[:2])
        cw, ch = crop[2] - crop[0], crop[3] - crop[1]
    else:
        cw = ch = 0
    if flip:
        m = np.array([[-1, 0, cw], [0, 1, 0], [0, 0, 1]], np.float64) @ m
    rad = rotate / 180 * np.pi
    rot = np.array(
        [[np.cos(rad), np.sin(rad), 0], [-np.sin(rad), np.cos(rad), 0], [0, 0, 1]]
    )
    center = np.array([cw, ch]) / 2
    rot[:2, 2] = -rot[:2, :2] @ center + center
    m = rot @ m
    out = np.eye(4)
    out[:3, :3] = m
    return out


def transform_image(img: np.ndarray, aug: Dict) -> np.ndarray:
    """Apply resize/crop/flip/rotate to one HxWx3 image (PIL when available,
    matching the reference's resampling; strided numpy fallback)."""
    resize_dims = aug["resize_dims"]
    crop = aug["crop"]
    try:
        from PIL import Image

        im = Image.fromarray(img.astype(np.uint8))
        im = im.resize(resize_dims).crop(crop)
        if aug.get("flip"):
            im = im.transpose(method=Image.FLIP_LEFT_RIGHT)
        if aug.get("rotate"):
            im = im.rotate(aug["rotate"])
        return np.asarray(im).astype(np.float32)
    except ImportError:  # minimal environments: nearest-neighbour path
        H, W = img.shape[:2]
        newW, newH = resize_dims
        yi = np.clip((np.arange(newH) / (newH / H)).astype(int), 0, H - 1)
        xi = np.clip((np.arange(newW) / (newW / W)).astype(int), 0, W - 1)
        out = img[yi][:, xi]
        x0, y0, x1, y1 = crop
        out = out[y0:y1, x0:x1]
        if aug.get("flip"):
            out = out[:, ::-1]
        return out.astype(np.float32)


def resize_crop_flip(
    imgs: Sequence[np.ndarray], lidar2img: np.ndarray, aug: Dict
) -> Tuple[np.ndarray, np.ndarray]:
    """All cameras; returns (images [cams, fH, fW, 3], updated lidar2img)."""
    mat = img_transform_matrix(aug)
    new_imgs = np.stack([transform_image(im, aug) for im in imgs])
    return new_imgs, (mat[None] @ lidar2img).astype(np.float32)


# --------------------------------------------------------------------------
# Photometric distortion with cross-frame consistency (`augment.py:141-298`)
# --------------------------------------------------------------------------

def _bgr2hsv(img: np.ndarray) -> np.ndarray:
    b, g, r = img[..., 0] / 255.0, img[..., 1] / 255.0, img[..., 2] / 255.0
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = (60 * ((g - b) / diff) % 360)[m]
    m = mx == g
    h[m] = (60 * ((b - r) / diff) + 120)[m]
    m = mx == b
    h[m] = (60 * ((r - g) / diff) + 240)[m]
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], axis=-1).astype(np.float32)


def _hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], np.clip(hsv[..., 1], 0, 1), hsv[..., 2]
    c = v * s
    hp = (h % 360) / 60.0
    x = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    idx = (hp.astype(int) % 6)[..., None]
    choices = [
        np.stack([c, x, z], -1), np.stack([x, c, z], -1), np.stack([z, c, x], -1),
        np.stack([z, x, c], -1), np.stack([x, z, c], -1), np.stack([c, z, x], -1),
    ]
    rgb = np.select([idx == k for k in range(6)], choices)
    rgb = rgb + (v - c)[..., None]
    return (rgb[..., ::-1] * 255.0).astype(np.float32)


def sample_distortion_params(rng: np.random.RandomState, num_cams: int) -> List[Dict]:
    """One param dict per camera; reused across frames of a sequence
    (``keep_distortion`` consistency, `augment.py:183-236`)."""
    params = []
    for _ in range(num_cams):
        p: Dict = {}
        if rng.randint(2):
            p["brightness"] = rng.uniform(-32, 32)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            p["contrast_pre"] = rng.uniform(0.5, 1.5)
        if rng.randint(2):
            p["saturation"] = rng.uniform(0.5, 1.5)
        if rng.randint(2):
            p["hue"] = rng.uniform(-18, 18)
        if mode == 0 and rng.randint(2):
            p["contrast_post"] = rng.uniform(0.5, 1.5)
        if rng.randint(2):
            p["permutation"] = rng.permutation(3)
        params.append(p)
    return params


def photometric_distortion(imgs: np.ndarray, params: List[Dict]) -> np.ndarray:
    """Apply per-camera distortion params to [cams, H, W, 3] BGR float32."""
    out = []
    for img, p in zip(imgs, params):
        img = img.copy()
        if "brightness" in p:
            img += p["brightness"]
        if "contrast_pre" in p:
            img *= p["contrast_pre"]
        if "saturation" in p or "hue" in p:
            hsv = _bgr2hsv(img)
            if "saturation" in p:
                hsv[..., 1] *= p["saturation"]
            if "hue" in p:
                hsv[..., 0] = (hsv[..., 0] + p["hue"]) % 360
            img = _hsv2bgr(hsv)
        if "contrast_post" in p:
            img *= p["contrast_post"]
        if "permutation" in p:
            img = img[..., p["permutation"]]
        out.append(img)
    return np.stack(out)


def normalize_image(imgs: np.ndarray, to_rgb: bool = True) -> np.ndarray:
    """BGR float32 -> standardized RGB (`transform.py:285-321`)."""
    if to_rgb:
        imgs = imgs[..., ::-1]
    return ((imgs - IMG_MEAN) / IMG_STD).astype(np.float32)


# --------------------------------------------------------------------------
# Multi-scale LiDAR depth GT (`transform.py:57-104`)
# --------------------------------------------------------------------------

def multiscale_depth_maps(
    points: np.ndarray,
    lidar2img: np.ndarray,
    img_hw: Tuple[int, int],
    strides: Sequence[int] = (4, 8, 16),
    max_depth: float = 60.0,
) -> List[np.ndarray]:
    """Project LiDAR points; per level keep one depth per pixel (last write).

    Args:
      points: [N, >=3] lidar-frame points; lidar2img: [cams, 4, 4].
    Returns list per stride of [cams, H//s, W//s] (0 = no depth).
    """
    H, W = img_hw
    num_cams = lidar2img.shape[0]
    pts_h = np.concatenate([points[:, :3], np.ones((len(points), 1))], axis=1)
    outs = []
    proj = np.einsum("cij,nj->cni", lidar2img, pts_h)
    z = proj[..., 2]
    uv = proj[..., :2] / np.maximum(z[..., None], 1e-5)
    for s in strides:
        h, w = H // s, W // s
        depth = np.zeros((num_cams, h, w), np.float32)
        u = (uv[..., 0] / s).astype(int)
        v = (uv[..., 1] / s).astype(int)
        valid = (z > 1e-5) & (z < max_depth) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        for c in range(num_cams):
            m = valid[c]
            depth[c, v[c, m], u[c, m]] = z[c, m]
        outs.append(depth)
    return outs


# --------------------------------------------------------------------------
# GT filters (`transform.py:168-283`)
# --------------------------------------------------------------------------

def circle_range_filter(boxes, labels, extras, dist: float = 55.0):
    """Keep boxes with center radius < dist (`CircleObjectRangeFilter`)."""
    keep = np.linalg.norm(boxes[:, :2], axis=1) < dist
    return boxes[keep], labels[keep], [e[keep] for e in extras]


def bev_range_filter(boxes, labels, extras, pc_range):
    keep = (
        (boxes[:, 0] > pc_range[0]) & (boxes[:, 0] < pc_range[3])
        & (boxes[:, 1] > pc_range[1]) & (boxes[:, 1] < pc_range[4])
    )
    return boxes[keep], labels[keep], [e[keep] for e in extras]


def limit_period(val, offset: float = 0.5, period: float = 2 * np.pi):
    return val - np.floor(val / period + offset) * period


# --------------------------------------------------------------------------
# Map polyline vectorization (`vectorize.py:210-414`)
# --------------------------------------------------------------------------

def interp_polyline(line: np.ndarray, num: int) -> np.ndarray:
    """Arc-length resample an [N, 2] polyline to ``num`` points."""
    seg = np.linalg.norm(np.diff(line, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    t = np.linspace(0, total, num)
    x = np.interp(t, s, line[:, 0])
    y = np.interp(t, s, line[:, 1])
    return np.stack([x, y], axis=1).astype(np.float32)


def permute_line(line: np.ndarray, padding: float = 1e5) -> np.ndarray:
    """(num_pts, 2) -> (2*(num_pts-1), num_pts, 2): cyclic shifts for closed
    polylines, [fwd, reversed] + padding for open ones (`vectorize.py:284-318`)."""
    num_pts = len(line)
    n_perm = 2 * (num_pts - 1)
    closed = np.allclose(line[0], line[-1], atol=1e-3)
    outs = []
    if closed:
        body = line[:-1]
        for s in range(num_pts - 1):
            outs.append(np.roll(body, s, axis=0))
        fbody = np.flip(body, axis=0)
        for s in range(num_pts - 1):
            outs.append(np.roll(fbody, s, axis=0))
        arr = np.stack(outs)
        arr = np.concatenate([arr, arr[:, :1]], axis=1)
    else:
        arr = np.stack([line, np.flip(line, axis=0)])
        pad = np.full((n_perm - 2, num_pts, 2), padding, np.float32)
        arr = np.concatenate([arr, pad], axis=0)
    return arr.astype(np.float32)


def vectorize_polylines(
    polylines: Sequence[np.ndarray], labels: Sequence[int], num_pts: int = 20
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (gt_map_labels [M], gt_map_pts [M, 2*(num_pts-1), num_pts, 2])."""
    pts, labs = [], []
    for line, lab in zip(polylines, labels):
        if len(line) < 2:
            continue
        pts.append(permute_line(interp_polyline(np.asarray(line, np.float64), num_pts)))
        labs.append(lab)
    if not pts:
        n_perm = 2 * (num_pts - 1)
        return (np.zeros((0,), np.int32), np.zeros((0, n_perm, num_pts, 2), np.float32))
    return np.asarray(labs, np.int32), np.stack(pts)


# --------------------------------------------------------------------------
# Fixed-capacity padding (TPU static shapes)
# --------------------------------------------------------------------------

def pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    k = min(len(arr), n)
    out[:k] = arr[:k]
    return out


def pad_gt_frame(frame: Dict[str, np.ndarray], max_boxes: int = MAX_GT_BOXES,
                 max_map: int = MAX_GT_MAP) -> Dict[str, np.ndarray]:
    """Pad a frame's ragged GT to fixed capacity + validity masks."""
    out = dict(frame)
    n = len(frame["gt_labels_3d"])
    out["gt_valid"] = (np.arange(max_boxes) < n)
    out["gt_labels_3d"] = pad_to(frame["gt_labels_3d"].astype(np.int32), max_boxes)
    out["gt_bboxes_3d"] = pad_to(frame["gt_bboxes_3d"].astype(np.float32), max_boxes)
    for k in ("gt_agent_fut_trajs", "gt_agent_fut_masks", "gt_attr_labels"):
        if k in frame:
            out[k] = pad_to(frame[k].astype(np.float32), max_boxes)
    if "instance_inds" in frame:
        out["instance_inds"] = pad_to(
            frame["instance_inds"].astype(np.int32), max_boxes, fill=-1
        )
    if "gt_map_labels" in frame:
        m = len(frame["gt_map_labels"])
        out["gt_map_valid"] = (np.arange(max_map) < m)
        out["gt_map_labels"] = pad_to(frame["gt_map_labels"].astype(np.int32), max_map)
        out["gt_map_pts"] = pad_to(frame["gt_map_pts"].astype(np.float32), max_map)
    return out
