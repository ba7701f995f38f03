"""Each traffic generator repeats from its seed and differs across seeds,
at the same sizes; the frame stream's cameras follow the configuration's
input size."""

import numpy as np
import pytest
import torch

from bench_h100.harness import spec, traffic

SEEDS = (2 ** 31 + 5, 2 ** 31 + 6)


def _frames(seed):
    from hipad_torch.configs import model as configs

    p = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    p["cameras"].update(pool=2, shapes=5)
    gen = traffic.StreamFrames(p, configs.tiny(num_cams=6, input_size=(64, 96)), seed, "cpu")
    return [gen.frame(i) for i in range(5)]


def test_camera_frames_repeat_and_differ():
    def make(seed):
        return traffic.camera_frames(3, 45, 80, 6, 2.0, traffic.generator(seed, "cpu"), "cpu")

    a, b, c = make(SEEDS[0]), make(SEEDS[0]), make(SEEDS[1])
    assert a.dtype == torch.uint8 and a.shape == (3, 45, 80, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_stream_frames_repeat_and_differ():
    a, b, c = _frames(SEEDS[0]), _frames(SEEDS[0]), _frames(SEEDS[1])
    for (ia, ma), (ib, mb) in zip(a, b):
        assert torch.equal(ia, ib) and all(np.array_equal(ma[k], mb[k]) for k in ma)
    assert not torch.equal(a[0][0], c[0][0])
    assert not np.array_equal(a[0][1]["T_global"], c[0][1]["T_global"])
    assert [m["timestamp"][0] for _, m in a] == [0.0, 0.5, 1.0, 1.5, 2.0]
    assert a[0][0].shape == c[0][0].shape == (1, 6, 64, 96, 3)


def _stream(cfg):
    """The frame stream at ``cfg``'s sizes, its pool cut to one frame of one
    shape (the metas do not depend on the pool)."""
    p = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    p["cameras"].update(pool=1, shapes=1)
    return traffic.StreamFrames(p, cfg, SEEDS[0], "cpu")


def test_stage2_projection_is_the_fixed_crops_bit_for_bit():
    """At ``stage2()``'s own 352x640 the rig's projection, focal and image
    size are, bit for bit, what the fixed test-time crop gave."""
    import math

    from bench_h100.reference.hipad.agent.calib import stacked_lidar2img
    from bench_h100.reference.hipad.data import pipelines as pp
    from hipad_torch.configs import model as configs

    aug = pp.sample_aug_config(pp.DATA_AUG_CONF, test_mode=True)
    lidar2img = (pp.img_transform_matrix(aug)[None] @ stacked_lidar2img()).astype(np.float32)
    focal = np.float32(aug["resize"] * 1600 / (2 * math.tan(math.radians(35))))
    cfg = configs.stage2(kmeans_dir=str(spec.KMEANS_DIR))
    gen = _stream(cfg)
    _, metas = gen.frame(3)
    assert gen.lidar2img.dtype == np.float32 and np.array_equal(gen.lidar2img, lidar2img)
    assert gen.focal.dtype == np.float32 and gen.focal == focal
    assert gen.wh == (640, 352)
    assert np.array_equal(metas["projection_mat"], lidar2img[None])
    assert np.array_equal(metas["image_wh"], np.full((1, 6, 2), (640, 352), np.float32))
    assert np.array_equal(metas["focal"], np.full((1, 6), focal, np.float32))


@pytest.mark.parametrize("factory,resize,crop", [
    ("stage2", 0.4, (0, 8, 640, 360)),
    ("stage2_r101_2x", 0.8, (0, 16, 1280, 720)),
])
def test_rig_aug_follows_the_input_size(factory, resize, crop):
    from hipad_torch.configs import model as configs

    aug = traffic.rig_aug(getattr(configs, factory)(kmeans_dir=str(spec.KMEANS_DIR)))
    assert aug["resize"] == resize and aug["crop"] == crop
    assert aug["resize_dims"] == crop[2:]
    assert (aug["flip"], aug["rotate"]) == (False, 0.0)


def _rig_points():
    """Ego-frame points (x forward, y left, z up) in front of each camera of
    the rig: 5 to 50 m out along bearings -40 to 40 degrees off its axis,
    on the ground and 1.5 m up; as lidar-frame homogeneous rows, with the
    camera each was made for."""
    from bench_h100.reference.hipad.agent.calib import CAMERA_RIG, LIDAR2EGO

    pts, cams = [], []
    for c, (x, y, _, yaw, _) in enumerate(CAMERA_RIG.values()):
        for d in (5.0, 10.0, 20.0, 35.0, 50.0):
            for off in (-40.0, -20.0, 0.0, 20.0, 40.0):
                a = np.radians(-yaw + off)  # CARLA's yaw is left-handed
                for z in (0.0, 1.5):
                    pts.append((x + d * np.cos(a), -y + d * np.sin(a), z, 1.0))
                    cams.append(c)
    return (np.linalg.inv(LIDAR2EGO) @ np.array(pts).T).T, np.array(cams)


def _project(gen, pts, cams):
    """Each point through its camera's ``projection_mat``, divided by depth
    and by ``image_wh`` as the sampler's ``project_points`` does."""
    _, metas = gen.frame(0)
    mat = metas["projection_mat"][0].astype(np.float64)[cams]  # [n, 4, 4]
    h = np.einsum("nij,nj->ni", mat, pts)
    assert (h[:, 2] > 0.1).all()  # every point lies in front of its camera
    return h[:, :2] / h[:, 2:3] / metas["image_wh"][0].astype(np.float64)[cams]


def test_projected_points_cover_the_image_at_every_input_size():
    """The rig's points land at the same normalised image coordinates at
    352x640 and 704x1280 (the same field of view, at twice the pixels), the
    same share of them inside the image; at 64x96, whose crop keeps less of
    the width, they land on the same pixels of the 1600x900 camera."""
    from hipad_torch.configs import model as configs

    pts, cams = _rig_points()
    norm, orig = {}, {}
    for size in ((352, 640), (704, 1280), (64, 96)):
        cfg = configs.tiny(num_cams=6, input_size=size)
        norm[size] = _project(_stream(cfg), pts, cams)
        aug = traffic.rig_aug(cfg)
        wh = np.array(size[::-1], np.float64)
        orig[size] = (norm[size] * wh + np.array(aug["crop"][:2])) / aug["resize"]
    a, b = norm[(352, 640)], norm[(704, 1280)]
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)

    def inside(n):
        return ((n >= 0) & (n <= 1)).all(-1)

    assert inside(a).sum() == inside(b).sum()
    assert 0.3 < inside(a).mean() < 1.0  # the bearings reach past the 70-degree cameras
    assert (b[inside(b)].max(0) > 0.75).all()  # not only the top-left quarter
    for size in ((704, 1280), (64, 96)):
        np.testing.assert_allclose(orig[size], orig[(352, 640)], rtol=0, atol=1e-2)
