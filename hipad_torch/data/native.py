"""The port's ctypes binding of the native host-IO library
(``csrc/image_ops.cpp``): the fused resize + crop + flip of all cameras in
one multithreaded C++ pass, as uint8 for the closed-loop agent's tick
(:func:`resize_crop_cameras_u8`) and normalised float32 RGB for the dataset
loader (:func:`preprocess_cameras`), and the LiDAR depth rasterisation
(:func:`depth_maps`).

The library is built at first use with ``g++`` and the flags of
``tools/build_native.sh`` into ``build/hipad_torch_native/`` at the root of
the checkout (rebuilt when the source is newer), and loaded with ``ctypes``.
A build that fails raises: there is no fallback to another resampler, and
no entry point returns None in place of its result.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
from typing import Dict, List, Sequence

import numpy as np

from . import pipelines as pp

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "image_ops.cpp"
BUILD_DIR = ROOT / "build" / "hipad_torch_native"
LIB_NAME = "libhipad_io.so"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if the source is newer than the library) and load it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / LIB_NAME
    if not out.exists() or out.stat().st_mtime < SOURCE.stat().st_mtime:
        tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}"
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.c_int
    lib.resize_crop_cameras_u8.argtypes = [u8p, u8p] + [i32] * 12
    lib.resize_crop_cameras_u8.restype = None
    lib.preprocess_cameras.argtypes = [u8p, f32p] + [i32] * 10 + [f32p, f32p, i32, i32]
    lib.preprocess_cameras.restype = None
    lib.depth_maps.argtypes = [f32p, i32, f32p, i32, i32, i32, ctypes.POINTER(i32), i32,
                               ctypes.c_float, ctypes.POINTER(f32p)]
    lib.depth_maps.restype = None
    return lib


def _cameras(imgs_u8: np.ndarray, aug: Dict) -> np.ndarray:
    """The checks both resize/crop entry points share -> the contiguous
    uint8 cameras."""
    if aug.get("rotate"):
        raise ValueError("the native resize/crop does not rotate; use "
                         "data.pipelines.transform_image for a rotated aug")
    imgs = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
    if imgs.ndim != 4 or imgs.shape[3] != 3:
        raise ValueError(f"cameras must be [cams, H, W, 3] uint8, got {imgs.shape}")
    return imgs


def resize_crop_cameras_u8(imgs_u8: np.ndarray, aug: Dict, to_rgb: bool = False,
                           num_threads: int = 0) -> np.ndarray:
    """``[cams, H, W, 3]`` uint8 -> the uint8 crop ``[cams, out_h, out_w,
    3]``, bilinear, rounded to nearest, no normalisation (the agent
    normalises on the card). ``aug`` is a test-time augmentation of
    ``data/pipelines.py`` (``resize_dims``, ``crop``, ``flip``); the native
    pass has no rotation, so a rotated ``aug`` raises."""
    imgs = _cameras(imgs_u8, aug)
    cams, src_h, src_w = imgs.shape[:3]
    rw, rh = aug["resize_dims"]
    x0, y0, x1, y1 = aug["crop"]
    out = np.empty((cams, y1 - y0, x1 - x0, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    library().resize_crop_cameras_u8(
        imgs.ctypes.data_as(u8p), out.ctypes.data_as(u8p), cams, src_h, src_w, rw, rh,
        x0, y0, y1 - y0, x1 - x0, int(bool(aug.get("flip"))), int(bool(to_rgb)),
        num_threads)
    return out


def preprocess_cameras(imgs_bgr_u8: np.ndarray, aug: Dict, num_threads: int = 0) -> np.ndarray:
    """``[cams, H, W, 3]`` uint8 BGR -> ``[cams, out_h, out_w, 3]`` float32
    RGB, normalised by ``pipelines.IMG_MEAN`` and ``IMG_STD``: the
    dataset's test-time image path, the geometry and bilinear sampling of
    :func:`resize_crop_cameras_u8` without the rounding. A rotated ``aug``
    raises."""
    imgs = _cameras(imgs_bgr_u8, aug)
    cams, src_h, src_w = imgs.shape[:3]
    rw, rh = aug["resize_dims"]
    x0, y0, x1, y1 = aug["crop"]
    out = np.empty((cams, y1 - y0, x1 - x0, 3), np.float32)
    mean = np.ascontiguousarray(pp.IMG_MEAN, np.float32)
    std = np.ascontiguousarray(pp.IMG_STD, np.float32)
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    library().preprocess_cameras(
        imgs.ctypes.data_as(u8p), out.ctypes.data_as(f32p), cams, src_h, src_w, rw, rh,
        x0, y0, y1 - y0, x1 - x0, int(bool(aug.get("flip"))), mean.ctypes.data_as(f32p),
        std.ctypes.data_as(f32p), 1, num_threads)
    return out


def depth_maps(points: np.ndarray, lidar2img: np.ndarray, img_hw, strides: Sequence[int],
               max_depth: float = 60.0) -> List[np.ndarray]:
    """LiDAR points ``[n, >=3]`` and ``lidar2img`` ``[cams, 4, 4]`` -> one
    ``[cams, H // s, W // s]`` float32 depth map per stride ``s`` (0 where
    no point lands; of several points in a cell, the last written)."""
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    l2i = np.ascontiguousarray(lidar2img, np.float32)
    if l2i.ndim != 3 or l2i.shape[1:] != (4, 4):
        raise ValueError(f"lidar2img must be [cams, 4, 4], got {l2i.shape}")
    cams = l2i.shape[0]
    H, W = img_hw
    outs = [np.zeros((cams, H // s, W // s), np.float32) for s in strides]
    f32p = ctypes.POINTER(ctypes.c_float)
    ptrs = (f32p * len(outs))(*[o.ctypes.data_as(f32p) for o in outs])
    st = np.ascontiguousarray(strides, np.int32)
    library().depth_maps(pts.ctypes.data_as(f32p), len(pts), l2i.ctypes.data_as(f32p), cams,
                         H, W, st.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(strides),
                         max_depth, ptrs)
    return outs
