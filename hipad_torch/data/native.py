"""The port's ctypes binding of the native host-IO library
(``csrc/image_ops.cpp``): the fused uint8 resize + crop + flip of all cameras
in one multithreaded C++ pass, which the closed-loop agent runs every tick.

The library is built at first use with ``g++`` and the flags of
``tools/build_native.sh`` into ``build/hipad_torch_native/`` at the root of
the checkout (rebuilt when the source is newer), and loaded with ``ctypes``.
A build that fails raises: there is no fallback to another resampler.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
from typing import Dict

import numpy as np

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
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.resize_crop_cameras_u8.argtypes = [u8p, u8p] + [ctypes.c_int] * 12
    lib.resize_crop_cameras_u8.restype = None
    return lib


def resize_crop_cameras_u8(imgs_u8: np.ndarray, aug: Dict, to_rgb: bool = False,
                           num_threads: int = 0) -> np.ndarray:
    """``[cams, H, W, 3]`` uint8 -> the uint8 crop ``[cams, out_h, out_w,
    3]``, bilinear, rounded to nearest, no normalisation (the agent
    normalises on the card). ``aug`` is a test-time augmentation of
    ``data/pipelines.py`` (``resize_dims``, ``crop``, ``flip``); the native
    pass has no rotation, so a rotated ``aug`` raises."""
    if aug.get("rotate"):
        raise ValueError("the native resize/crop does not rotate; use "
                         "data.pipelines.transform_image for a rotated aug")
    imgs = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
    if imgs.ndim != 4 or imgs.shape[3] != 3:
        raise ValueError(f"cameras must be [cams, H, W, 3] uint8, got {imgs.shape}")
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
