"""The port's data path of the open-loop eval and of training on a dataset,
against the JAX package's: the native binding's ``preprocess_cameras`` and
``depth_maps``, ``Bench2DriveDataset`` frames in test and train mode, and
``TrainLoader`` batches for two ranks.

Both packages call the same ``csrc/image_ops.cpp`` (built with the same
flags) and run the same numpy code on the same infos, so every comparison
with JAX is bit for bit. Against the numpy pipeline the bounds are those of
``tests/test_native_io.py``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from hipad_torch.data import native as tnative
from hipad_torch.data import pipelines as pp
from hipad_torch.data.bench2drive import Bench2DriveDataset as TDataset
from hipad_torch.data.sampler import TrainLoader as TLoader
from hipad_tpu.data import native as jnative
from hipad_tpu.data.bench2drive import Bench2DriveDataset as JDataset
from hipad_tpu.data.sampler import TrainLoader as JLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import data_converter as dc  # noqa: E402

AUG_CONF = {"resize_lim": (0.38, 0.45), "final_dim": (64, 96), "bot_pct_lim": (0.0, 0.0),
            "rot_lim": (-5.4, 5.4), "H": 160, "W": 240, "rand_flip": True,
            "rot3d_range": (0.0, 0.0)}
PLAN_TYPES = (("temp", "2hz"), ("spat", "2m"), ("speed", "2hz", (0.0, 3.0)),
              ("speed", "2hz", (3.0, 999.0)))
# frames whose camera files exist; the others are absent and load as zeros
WITH_FILES = (0, 1, 2, 5, 40)


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's binding returns None without its library: build it
    as ``tests/test_native_io.py`` does."""
    if not jnative.available():
        subprocess.run(["bash", os.path.join(ROOT, "tools", "build_native.sh")], check=True)
        jnative._lib = None
    assert jnative.available()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Two 40-frame routes of ``test_dataset_roundtrip._raw_anno`` infos and
    seeded JPEGs for the cameras of a few frames -> (pkl, data_root)."""
    from test_dataset_roundtrip import _raw_anno

    tmp = tmp_path_factory.mktemp("b2d_eval_data")
    frames = []
    for route in range(2):
        last = {}
        for i in range(40):
            frames.append(dc.convert_frame(_raw_anno(i / 10.0, 0.5 * i),
                                           f"v1/Town01_route{route}", i, "Town01", last))
    pkl = tmp / "val.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(frames, f)
    root = tmp / "data"
    from PIL import Image

    ds = TDataset(ann_file=str(pkl), data_root=str(root), plan_anchor_types=PLAN_TYPES,
                  data_aug_conf=AUG_CONF)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:160, 0:240]
    for i in WITH_FILES:
        for p in ds.get_data_info(i)["img_filename"]:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            base = np.stack([xx, yy, xx + yy], -1) * rng.uniform(0.3, 1.0, 3)
            img = np.clip(base + rng.randint(0, 40, (160, 240, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(p, "JPEG", quality=90)
    return str(pkl), str(root)


def _datasets(split, test_mode):
    pkl, root = split
    kw = dict(ann_file=pkl, data_root=root, test_mode=test_mode, plan_anchor_types=PLAN_TYPES,
              data_aug_conf=AUG_CONF)
    return TDataset(**kw), JDataset(**kw)


def _equal(got, ref, what):
    assert got.keys() == ref.keys(), (what, set(got) ^ set(ref))
    for k in ref:
        if isinstance(ref[k], list):
            assert got[k] == ref[k], (what, k)
            continue
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}[{k}]")


def _numpy_resize_crop(img, aug):
    """``tests/test_native_io.py``'s numpy reference: bilinear resize with
    clamped edges, crop, BGR -> RGB, normalise."""
    sh, sw = img.shape[:2]
    rw, rh = aug["resize_dims"]
    ys = np.clip((np.arange(rh) + 0.5) * sh / rh - 0.5, 0, sh - 1)
    xs = np.clip((np.arange(rw) + 0.5) * sw / rw - 0.5, 0, sw - 1)
    y0, x0 = ys.astype(int), xs.astype(int)
    y1, x1 = np.minimum(y0 + 1, sh - 1), np.minimum(x0 + 1, sw - 1)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = img.astype(np.float64)
    out = ((1 - wy) * ((1 - wx) * img[y0][:, x0] + wx * img[y0][:, x1])
           + wy * ((1 - wx) * img[y1][:, x0] + wx * img[y1][:, x1]))
    cx0, cy0, cx1, cy1 = aug["crop"]
    out = out[cy0:cy1, cx0:cx1]
    if aug["flip"]:
        out = out[:, ::-1]
    return ((out[..., ::-1] - pp.IMG_MEAN) / pp.IMG_STD).astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_cameras_matches_jax_binding(flip):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (3, 90, 160, 3), np.uint8)
    aug = {"resize": 0.4, "resize_dims": (64, 36), "crop": (0, 4, 64, 36), "flip": flip,
           "rotate": 0.0}
    got = tnative.preprocess_cameras(imgs, aug, num_threads=2)
    assert got.dtype == np.float32 and got.shape == (3, 32, 64, 3)
    np.testing.assert_array_equal(got, jnative.preprocess_cameras(imgs, aug, num_threads=2))
    expect = np.stack([_numpy_resize_crop(im, aug) for im in imgs])
    np.testing.assert_allclose(got, expect, atol=2e-2)


def test_depth_maps_match_jax_binding():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-10, 30, (200, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    l2i[:, 0, 0] = l2i[:, 1, 1] = 80.0
    l2i[:, 0, 2] = 32.0
    l2i[:, 1, 2] = 16.0
    got = tnative.depth_maps(pts, l2i, (32, 64), strides=(4, 8))
    ref = jnative.depth_maps(pts, l2i, (32, 64), strides=(4, 8))
    assert len(got) == len(ref) == 2
    for g, j in zip(got, ref):
        np.testing.assert_array_equal(g, j)
    for g, r in zip(got, pp.multiscale_depth_maps(pts, l2i.astype(np.float64), (32, 64),
                                                   strides=(4, 8))):
        assert ((g > 0) == (r > 0)).mean() > 0.99  # test_native_io.py's bound


def test_native_entry_points_raise_on_what_they_cannot_do():
    imgs = np.zeros((1, 8, 8, 3), np.uint8)
    aug = {"resize_dims": (8, 8), "crop": (0, 0, 8, 8), "flip": False, "rotate": 2.0}
    with pytest.raises(ValueError, match="rotate"):
        tnative.preprocess_cameras(imgs, aug)
    with pytest.raises(ValueError, match="cams, H, W, 3"):
        tnative.preprocess_cameras(imgs[..., 0], dict(aug, rotate=0.0))


@pytest.mark.parametrize("mode", ["test", "train-native", "train-numpy"])
def test_dataset_frames_match_jax(split, mode):
    """Every key of every requested frame, bit for bit: test mode (the
    eval's aug, the native path), train mode with a fixed aug and no
    distortion (native), and with rotation and photometric distortion
    (the numpy path). Frames with and without camera files."""
    tds, jds = _datasets(split, test_mode=mode == "test")
    rng = np.random.RandomState(5)
    for idx in (0, 1, 7, 40, 63):
        if mode == "test":
            req = {"idx": idx, "aug_config": None}
        else:
            aug = pp.sample_aug_config(AUG_CONF, rng)
            dist = None
            if mode == "train-native":
                aug["rotate"] = 0.0
            else:
                dist = pp.sample_distortion_params(rng, 6)
            req = {"idx": idx, "aug_config": aug, "distortion": dist}
        got, ref = tds[dict(req)], jds[dict(req)]
        _equal(got, ref, f"{mode} frame {idx}")
        if mode != "train-numpy":  # zeros stay constant through resize and crop
            varies = (got["images"].std(axis=(0, 1, 2)) > 0.1).all()
            assert varies == (idx in WITH_FILES), (mode, idx)
    assert tds.flag.tolist() == jds.flag.tolist()


def test_train_loader_batches_match_jax_for_two_ranks(split):
    """Global batch 4 over two ranks: each rank's slots of the same seeded
    sampler, its augmentation and distortion per sequence, 3 batches."""
    tds, jds = _datasets(split, test_mode=False)
    for rank in (0, 1):
        tl = iter(TLoader(tds, 4, seed=3, rank=rank, world=2))
        jl = iter(JLoader(jds, 4, seed=3, rank=rank, world=2))
        for step in range(3):
            got, ref = next(tl), next(jl)
            assert got["images"].shape[0] == 2
            _equal(got, ref, f"rank {rank} batch {step}")


def test_load_images_raises_for_a_present_file_without_pil(split, monkeypatch):
    """The original loads zeros for a file it cannot decode without PIL;
    the port raises. An absent file still loads as zeros."""
    tds, _ = _datasets(split, test_mode=True)
    present = tds.get_data_info(WITH_FILES[0])["img_filename"]
    absent = tds.get_data_info(3)["img_filename"]
    assert all(map(os.path.exists, present)) and not any(map(os.path.exists, absent))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        tds.load_images(present)
    zeros = tds.load_images(absent)
    assert zeros.shape == (6, 160, 240, 3) and not zeros.any()
