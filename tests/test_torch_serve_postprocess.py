"""The port's post-processing against the JAX package's on the CPU: both fed
the same numpy model outputs, built so that every branch is taken.

  * detection scores with ties (quantised logits and centerness), ranked by
    the squeezed class score and re-ranked by centerness: ties go to the
    lower anchor on both sides;
  * plan modes that drive into a confident agent (the -999 rescore), and a
    sample where every mode collides (no penalty; speed trajectories zeroed);
  * speed buckets on the 5 Hz reference, at 6 steps and, with ``tiny``'s 4
    steps, past the end of the trajectory (JAX clamps the step index).

Indices and labels must be equal; floats agree to 1e-6 of each output's
largest value (the same fp32 arithmetic: sigmoid, cumsum, atan2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch import postprocess as tpost
from hipad_torch.configs.model import GROUND_HEIGHT, HiPADConfig, PointKeypointSpec, tiny
from hipad_torch.postprocess import plan as tplan
from hipad_tpu import postprocess as jpost
from hipad_tpu.postprocess import plan as jplan

RTOL = 1e-6
BS, LAYERS, P = 2, 2, 16

CONFIGS = {
    # the stage-2 anchor types (temp 2 Hz rescored, 5 Hz and 2 Hz speed
    # buckets) at tiny counts, 6 steps of plan and of motion
    "stage2_types": dict(ego_fut_ts=6, fut_ts=6, plan_kps=PointKeypointSpec(6, 2, (0.0, 0.5), GROUND_HEIGHT),
                         plan_anchor_types=HiPADConfig.plan_anchor_types, ego_fut_mode=5,
                         plan_anchor_refer=("spat", "2m"), plan_speed_refer=("temp", "5hz"),
                         det_num_output=10),
    # tiny's own types: 4 steps, speed reference 5 Hz (steps 2 and 5)
    "tiny_types": dict(det_num_output=10),
}


def _outputs(cfg, rng):
    """Per-layer output stacks of a frame, numpy, with collisions arranged."""
    ts, n_plan = cfg.ego_fut_ts, cfg.num_plan_anchor
    # det: quantised logits and centerness -> ties in both rankings
    det_cls = rng.choice([-2.0, 0.0, 1.0, 2.0], (LAYERS, BS, P, cfg.num_det_classes))
    quality = rng.choice([-1.0, 0.0, 1.0], (LAYERS, BS, P, 2))
    det = np.zeros((LAYERS, BS, P, 11))
    det[..., :2] = rng.uniform(-30, 30, (LAYERS, BS, P, 2))
    det[..., 3:6] = np.log(rng.uniform(1.0, 3.0, (LAYERS, BS, P, 3)))
    yaw = rng.uniform(-np.pi, np.pi, (LAYERS, BS, P))
    det[..., 6], det[..., 7] = np.sin(yaw), np.cos(yaw)
    det[..., 8:] = rng.normal(size=(LAYERS, BS, P, 3))
    # sample 0: a confident 2 m agent parked 6 m ahead (+y); sample 1: a
    # confident 200 m agent around the ego, which every mode hits
    det[-1, 0, 0, :6] = (0.0, 6.0, 0.0, np.log(2.0), np.log(2.0), np.log(1.5))
    det[-1, 1, 0, :6] = (0.0, 0.0, 0.0, np.log(200.0), np.log(200.0), np.log(1.5))
    det[-1, :, 0, 6:8] = (0.0, 1.0)
    det_cls[-1, :, 0, 0] = 4.0
    m_cls = rng.normal(size=(LAYERS, BS, P, cfg.fut_mode))
    m_reg = rng.normal(scale=0.5, size=(LAYERS, BS, P, cfg.fut_mode, cfg.fut_ts, 2))
    m_reg[-1, :, 0] = 0.0  # the arranged agents stand still
    # plan: mode j of each group heads at angle j * 2 pi / modes; mode 0
    # straight ahead (+y), 1.5 m per step
    ang = np.pi / 2 + 2 * np.pi * np.arange(n_plan) / cfg.ego_fut_mode
    step = 1.5 * np.stack([np.cos(ang), np.sin(ang)], -1)  # [N, 2]
    plan = np.broadcast_to(step[None, None, None, :, None], (LAYERS, BS, 1, n_plan, ts, 2)).copy()
    plan += rng.normal(scale=0.05, size=plan.shape)
    plan_cls = rng.normal(size=(LAYERS, BS, 1, n_plan))
    return {
        "det": {"classification": det_cls, "prediction": det, "quality": quality,
                "instance_id": rng.permutation(np.arange(BS * P)).reshape(BS, P)},
        "map": {"classification": rng.normal(size=(LAYERS, BS, cfg.num_map_anchor,
                                                   cfg.num_map_classes)),
                "prediction": rng.normal(size=(LAYERS, BS, cfg.num_map_anchor,
                                               cfg.map_num_pts * 2))},
        "ego": {"status": rng.normal(size=(LAYERS, BS, 1, 10))},
        "plan": {"classification": plan_cls, "prediction": plan},
        "motion": {"classification": m_cls, "prediction": m_reg},
    }


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _as(a, lib):
    a = np.asarray(a)
    dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
    return jnp.asarray(a.astype(dt)) if lib == "jax" else torch.from_numpy(a.astype(dt))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_post_process_arrays_matches_jax(name):
    cfg = tiny(**CONFIGS[name])
    rng = np.random.default_rng(31)
    out = _outputs(cfg, rng)
    cmd = np.eye(cfg.num_command, dtype=np.float32)[[3, 1]]
    ref = jax.jit(lambda o, c: jpost.post_process_arrays(cfg, o, c))(
        _tree(out, lambda a: _as(a, "jax")), jnp.asarray(cmd))
    got = tpost.post_process_arrays(cfg, _tree(out, lambda a: _as(a, "torch")),
                                    torch.from_numpy(cmd))
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k in sorted(ref):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if np.issubdtype(r.dtype, np.integer) or r.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            err = np.abs(g.astype(np.float64) - r).max()
            assert err <= RTOL * max(np.abs(r).max(), 1.0), f"{k}: {err:.3e}"

    # the arranged cases were taken: ties among the detection scores, a
    # collision in sample 0, every mode colliding in sample 1
    scores = got["det_scores_3d"].numpy()
    assert (np.diff(scores, axis=1) == 0).any()
    t = _tree(out, lambda a: _as(a, "torch"))
    reg = torch.cumsum(t["plan"]["prediction"][-1][:, 0, :cfg.ego_fut_mode], dim=-2)
    new_cls, all_col = tplan.rescore(
        t["plan"]["classification"][-1][:, 0, :cfg.ego_fut_mode], reg,
        torch.sigmoid(t["motion"]["classification"][-1]),
        torch.cumsum(t["motion"]["prediction"][-1], dim=-2), t["det"]["prediction"][-1],
        torch.sigmoid(t["det"]["classification"][-1]).max(dim=-1).values)
    assert all_col.tolist() == [False, True]
    assert (new_cls[0] < -900).any() and (new_cls[0] > -900).any()
    assert (new_cls[1] > -900).all()

    dicts_t, dicts_j = tpost.to_result_dicts(got), jpost.to_result_dicts(ref)
    assert len(dicts_t) == len(dicts_j) == BS
    for a, b, c in zip(dicts_t, dicts_j, tpost.post_process(cfg, t, cmd)):
        assert set(a) == set(b) == set(c)
        for key in a:
            np.testing.assert_array_equal(a[key], c[key], err_msg=key)
        assert {"boxes_3d", "scores_3d", "labels_3d", "instance_ids", "trajs_3d",
                "vectors", "plan_mode_idx", "ego_status"} <= set(a)


def test_rescore_and_get_yaw_match_jax():
    """The collision rescore on its own, with modes on both sides of an
    agent, and ``get_yaw`` at zero displacement (keeps the start yaw)."""
    rng = np.random.default_rng(32)
    bs, mode, ts, n, mm = 2, 6, 4, 5, 3
    plan = np.cumsum(rng.normal(scale=2.0, size=(bs, mode, ts, 2)), axis=2)
    plan[:, 0] = 0.0  # a standing mode: get_yaw keeps pi/2
    det = np.zeros((bs, n, 11))
    det[..., :2] = plan[:, 1:, -1] + rng.normal(scale=0.5, size=(bs, n, 2))
    det[..., 3:6] = np.log(2.0)
    det[..., 7] = 1.0
    conf = rng.uniform(0.0, 0.3, (bs, n))
    m_cls = rng.uniform(size=(bs, n, mm))
    m_reg = np.cumsum(rng.normal(scale=0.2, size=(bs, n, mm, ts, 2)), axis=3)
    cls = rng.normal(size=(bs, mode))
    args = (cls, plan, m_cls, m_reg, det, conf)
    ref = jax.jit(jplan.rescore)(*(_as(a, "jax") for a in args))
    got = tplan.rescore(*(_as(a, "torch") for a in args))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    assert (got[0].numpy() < -900).any()
    traj = _as(np.concatenate([np.zeros((bs, mode, 1, 2)), plan], 2), "torch")
    yaw_t = tplan.get_yaw(traj, np.pi / 2)
    yaw_j = jax.jit(jplan.get_yaw)(_as(traj.numpy(), "jax"), jnp.pi / 2)
    np.testing.assert_allclose(yaw_t.numpy(), np.asarray(yaw_j), rtol=0, atol=1e-6)
    assert (yaw_t[:, 0].numpy() == np.float32(np.pi / 2)).all()
