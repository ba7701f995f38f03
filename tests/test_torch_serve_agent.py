"""The port's closed-loop agent against the JAX package's on the CPU, fp32:
the same observations from the fake simulator, the same weights, ``tiny``
with six cameras (so the real rig calibration applies) and two banks in
round robin over three ticks, so the third tick reuses the first tick's
bank.

Also the camera preprocessing: the port's native resize/crop is byte-equal
to the JAX package's where that one takes its native route, and within
``tests/test_native_io.py``'s bound of its PIL route where it takes that.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.agent import core as tcore
from hipad_torch.agent.replay import FakeSim, run_replay
from hipad_torch.configs.model import tiny
from hipad_torch.weights import to_jax
from hipad_tpu.agent import core as jcore
from hipad_tpu.data import native as jnative
from test_torch_port_model import _port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

AUG_CONF = {
    "resize_lim": (0.4, 0.4), "final_dim": (64, 128), "bot_pct_lim": (0.0, 0.0),
    "rot_lim": (0.0, 0.0), "H": 90, "W": 160, "rand_flip": False, "rot3d_range": (0.0, 0.0),
}
# plans: a model forward (fp32, sums in another order) then cumsums:
# |diff| <= RTOL * max|jax| + ATOL; controls: the PID of those plans.
RTOL, ATOL = 1e-4, 1e-5
N_BANKS, TICKS = 2, 3


@pytest.fixture(scope="module")
def agents():
    cfg = tiny(num_cams=6, input_size=(64, 128))
    model = _port(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax(model.state_dict()))
    kw = dict(jpeg_quality=20, aug_conf=AUG_CONF, n_banks=N_BANKS)
    return (tcore.AgentCore(cfg, model.state_dict(), dtype=torch.float32, device="cpu", **kw),
            jcore.AgentCore(cfg, variables, dtype=None, **kw))


def _port_agent(agents, **kw):
    """A fresh port agent on the fixture's weights (the fixture's pair stays
    in step for the comparison)."""
    port, _ = agents
    return tcore.AgentCore(port.cfg, port.model.state_dict(), dtype=torch.float32,
                           device="cpu", aug_conf=AUG_CONF, **kw)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= RTOL * np.abs(ref).max() + ATOL, f"{what}: {err:.3e}"


def test_agent_ticks_match_jax(agents):
    """Three ticks on the same ``_build_inputs`` output (the images byte for
    byte equal to the JAX package's own, where it takes its native route):
    the decoded plans and the controls of both agents; the banks turn over
    in round robin."""
    port, ref = agents
    sim = FakeSim(route_length=30.0, img_hw=(90, 160), seed=1)
    for tick in range(TICKS):
        obs = sim.observe()
        (ti, tm, tt), (ji, jm, jt) = port._build_inputs(obs), jcore.AgentCore._build_inputs(ref, obs)
        assert ti.dtype == np.uint8 and ti.shape == ji.shape == (1, 6, 64, 128, 3)
        if jnative.serving_available():
            np.testing.assert_array_equal(ti, ji)
        for k in jm:
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
        np.testing.assert_array_equal(tt, jt)
        bank_before = list(port.banks)
        c_t = port.run_step(obs)
        # the JAX agent takes the port's inputs: where its own library is not
        # built it resamples with PIL, which is not the native pass
        ref._build_inputs = lambda o, built=(ti, tm, tt): built
        c_j = ref.run_step(obs)
        mt, mj = c_t["metadata"], c_j["metadata"]
        _close(mt["plan_temp"], mj["plan_temp"], f"tick {tick} plan_temp")
        _close(mt["plan_spat"], mj["plan_spat"], f"tick {tick} plan_spat")
        for k in ("steer", "throttle", "brake"):
            assert abs(c_t[k] - c_j[k]) <= 1e-4, (tick, k, c_t[k], c_j[k])
        assert -1 <= c_t["steer"] <= 1 and 0 <= c_t["throttle"] <= 0.75
        assert 0 <= c_t["brake"] <= 1
        changed = [i for i, b in enumerate(port.banks) if b is not bank_before[i]]
        assert changed == [tick % N_BANKS]
        assert (bank_before[tick % N_BANKS] is None) == (tick < N_BANKS)
        sim.apply(c_t)
    assert set(port.metric_info) == set(range(TICKS))
    assert set(port.last_phase_ms) == {"host_preproc", "upload_infer"}


def test_replay_on_the_port(agents):
    """``run_replay`` drives the port's agent through the fake simulator."""
    port = _port_agent(agents, n_banks=N_BANKS)
    log = run_replay(port, max_steps=2, sim=FakeSim(route_length=30.0, img_hw=(90, 160)))
    assert len(log) == 2
    assert all(np.isfinite([e["steer"], e["throttle"], e["brake"]]).all() for e in log)


def _frames(sizes):
    """Smooth scenes (gradients), as test_native_io.py draws them: PIL's
    area filter and the native 2-tap bilinear agree on smooth content."""
    out = []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w]
        out.append(np.stack([xx * 255 / (w - 1), yy * 255 / (h - 1), (xx + yy + 40 * i) % 256],
                            -1).astype(np.uint8))
    return out


def test_prepare_cameras_matches_jax():
    """Cameras of one size: the native route on both sides (byte-equal), or,
    where the JAX package finds no built library, its PIL route (mean
    difference below 4 on the smooth channels). Cameras of different sizes:
    the PIL route on both sides, byte-equal."""
    aug = {"resize": 0.4, "resize_dims": (64, 36), "crop": (0, 4, 64, 36), "flip": False,
           "rotate": 0.0}
    same = _frames([(90, 160)] * 3)
    got = tcore.prepare_cameras(same, aug, jpeg_quality=None)
    ref = jcore.prepare_cameras(same, aug, jpeg_quality=None)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (3, 32, 64, 3)
    if jnative.serving_available():
        np.testing.assert_array_equal(got, ref)
    else:
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert float(np.mean(diff[..., :2])) < 4.0
    mixed = _frames([(90, 160), (100, 160)])
    np.testing.assert_array_equal(tcore.prepare_cameras(mixed, aug, jpeg_quality=20),
                                  jcore.prepare_cameras(mixed, aug, jpeg_quality=20))


def test_visualize_dir_writes_composites(agents, tmp_path):
    """With ``visualize_dir`` the agent writes its multi-camera and BEV
    composite every ``visualize_interval``-th tick (``utils/viz.py``), as the
    JAX package's agent does."""
    port = _port_agent(agents, visualize_dir=str(tmp_path), visualize_interval=2)
    sim = FakeSim(img_hw=(90, 160))
    for _ in range(3):
        port.run_step(sim.observe())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["000000.jpg", "000002.jpg"]
    from PIL import Image

    h, w = port.cfg.input_size
    assert Image.open(tmp_path / "000000.jpg").size == (3 * w + 2 * h, 2 * h)
