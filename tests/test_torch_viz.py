"""The port's composite dumps against the JAX package's on the CPU:
``core/box3d.py:box3d_to_corners``, ``utils/viz.py`` (a verbatim copy,
whose relative import reaches the port's corners) rendering the same
result dict, and the agent's dump of one tick."""

import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.agent import core as tcore
from hipad_torch.agent.calib import CAMERAS, stacked_lidar2img
from hipad_torch.configs.model import tiny
from hipad_torch.core.box3d import box3d_to_corners
from hipad_torch.utils import viz as tviz
from hipad_tpu.agent import core as jcore
from hipad_tpu.core import box3d as jbox3d
from hipad_tpu.utils import viz as jviz

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _boxes(rng, n):
    """Decoded boxes [x, y, z, w, l, h, yaw, vx, vy, vz] across the BEV."""
    b = np.zeros((n, 10), np.float32)
    b[:, :2] = rng.uniform(-40, 40, (n, 2))
    b[:, 2] = rng.uniform(-2, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_viz_draws_with_the_ports_corners():
    assert tviz.box3d_to_corners is box3d_to_corners


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_box3d_to_corners_equals_jax(shape):
    """The same corners in the same order, from arrays (float32, as JAX
    takes them) and from tensors."""
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, int(np.prod(shape))).reshape(shape + (10,))
    ref = np.asarray(jbox3d.box3d_to_corners(jnp.asarray(boxes)))
    got = box3d_to_corners(boxes)
    assert got.shape == shape + (8, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(box3d_to_corners(torch.from_numpy(boxes)).numpy(), got.numpy())
    unit = box3d_to_corners(np.array([[0, 0, 0, 2, 4, 6, 0]], np.float32))[0]
    np.testing.assert_array_equal(unit.numpy(), [[-1, -2, -3], [-1, -2, 3], [-1, 2, 3],
                                                 [-1, 2, -3], [1, -2, -3], [1, -2, 3],
                                                 [1, 2, 3], [1, 2, -3]])


def _result(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return {
        "boxes_3d": _boxes(rng, n),
        "scores_3d": rng.uniform(0, 1, n).astype(np.float32),
        "labels_3d": rng.integers(0, 9, n),
        "vectors": rng.uniform(-30, 30, (12, 20, 2)).astype(np.float32),
        "scores": rng.uniform(0, 1, 12).astype(np.float32),
        "labels": rng.integers(0, 4, 12),
        "plan_spat_2m": np.cumsum(rng.uniform(0, 2, (6, 2)), 0).astype(np.float32),
        "plan_speed_5hz": np.cumsum(rng.uniform(0, 2, (6, 2)), 0).astype(np.float32),
        "plan_temp_2hz": np.cumsum(rng.uniform(0, 2, (6, 2)), 0).astype(np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_render_frame_and_composite_equal_jax(seed):
    """Bit for bit on the same result dict: the BEV frame, and the 2x3
    camera mosaic with the BEV panel on the rig's projections."""
    res = _result(seed)
    np.testing.assert_array_equal(tviz.render_frame(res), jviz.render_frame(res))
    rng = np.random.default_rng(seed + 10)
    cams = {cam: rng.integers(0, 255, (90, 160, 3), dtype=np.uint8) for cam in CAMERAS}
    l2i = {cam: m for cam, m in zip(CAMERAS, stacked_lidar2img().astype(np.float32))}
    tp = np.array([1.5, 12.0], np.float32)
    got = tviz.render_composite(cams, l2i, res, target_point=tp)
    assert got.shape == (180, 3 * 160 + 180, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviz.render_composite(cams, l2i, res, target_point=tp))


def test_agent_dump_equals_the_jax_agents(tmp_path):
    """One tick's dump: the port's ``AgentCore._dump_composite`` and the JAX
    package's, on the same decoded arrays and observation, write the same
    JPEG."""
    cfg = tiny(num_cams=6, input_size=(64, 128))
    rng = np.random.default_rng(2)
    res = _result(2)
    decoded = {"det_boxes_3d": res["boxes_3d"][None], "det_scores_3d": res["scores_3d"][None],
               "det_labels_3d": res["labels_3d"][None], "map_vectors": res["vectors"][None],
               "map_scores": res["scores"][None], "map_labels": res["labels"][None],
               "plan_spat_2m": res["plan_spat_2m"][None],
               "plan_speed_5hz": res["plan_speed_5hz"][None]}
    obs = {"images": {cam: rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)
                      for cam in CAMERAS}}
    l2i = stacked_lidar2img().astype(np.float32)
    tp = np.array([0.5, 9.0], np.float32)
    for name, cls in (("torch", tcore.AgentCore), ("jax", jcore.AgentCore)):
        agent = SimpleNamespace(cfg=cfg, lidar2img=l2i, step=4,
                                visualize_dir=str(tmp_path / name))
        cls._dump_composite(agent, decoded, obs, tp)
    got = (tmp_path / "torch" / "000004.jpg").read_bytes()
    assert got == (tmp_path / "jax" / "000004.jpg").read_bytes()
