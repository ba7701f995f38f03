"""The port's auxiliary plan losses (``hipad_torch/losses/plan_aux.py``)
against ``hipad_tpu/losses/plan_aux.py`` on the same seeded inputs, and
their wiring into ``compute_losses`` with ``PLAN_{BOUND,COL,DIR}_W`` set to
1.0 on both sides, as ``tests/test_plan_aux_losses.py`` enables them.

Tolerance: the same fp32 arithmetic (norms, argmins, arctan2) in both
packages; a minimum's index can differ only on an exact tie, and the
inputs are continuous draws: |diff| <= RTOL * max|ref| + ATOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.losses import hipad_loss, plan_aux
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.weights import init_random
from hipad_tpu.losses import hipad_loss as jloss
from hipad_tpu.losses import plan_aux as jaux

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if ref.size else 0.0
    tol = RTOL * (np.abs(ref).max() if ref.size else 0.0) + ATOL
    assert err <= tol, f"{what}: max_abs_err {err:.3e} > {tol:.3e}"


def _both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_loss_matches_jax(seed):
    """Random trajectories among random polylines and agents of a few
    metres, so that every threshold and filter is crossed both ways."""
    rng = np.random.default_rng(seed)
    B, T, V, P, A, mode, ncls = 3, 6, 5, 7, 9, 3, 10
    traj = np.cumsum(rng.uniform(-1.5, 1.5, (B, T, 2)), axis=1).astype(np.float32)
    offsets = rng.uniform(-1.5, 1.5, (B, T, 2)).astype(np.float32)
    offsets[0] *= 0.05  # a static ego
    lanes = rng.uniform(-4, 4, (B, V, P, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, (B, V, 4)).astype(np.float32)
    pos = rng.uniform(-4, 4, (B, A, 2)).astype(np.float32)
    ascores = rng.uniform(0, 1, (B, A, ncls)).astype(np.float32)
    fut = np.cumsum(rng.uniform(-1, 1, (B, A, mode, T, 2)), axis=-2).astype(np.float32)
    fut_cls = rng.standard_normal((B, A, mode)).astype(np.float32)

    (t_traj, t_lanes, t_scores), (j_traj, j_lanes, j_scores) = _both(traj, lanes, scores)
    _close(plan_aux.plan_map_bound_loss(t_traj, t_lanes, t_scores),
           jaux.plan_map_bound_loss(j_traj, j_lanes, j_scores), "bound")
    (t_off,), (j_off,) = _both(offsets)
    _close(plan_aux.plan_map_dir_loss(t_off, t_lanes, t_scores),
           jaux.plan_map_dir_loss(j_off, j_lanes, j_scores), "dir")
    t, j = _both(pos, ascores, fut, fut_cls)
    _close(plan_aux.plan_collision_loss(t_traj, *t), jaux.plan_collision_loss(j_traj, *j),
           "collision")
    a0, a1, b0, b1 = (rng.uniform(-2, 2, (64, 2)).astype(np.float32) for _ in range(4))
    t, j = _both(a0, a1, b0, b1)
    np.testing.assert_array_equal(plan_aux.segments_intersect(*t).numpy(),
                                  np.asarray(jaux.segments_intersect(*j)))


def test_hand_built_scenarios():
    """The cases of ``tests/test_plan_aux_losses.py``: a boundary 0.5 m
    beside a straight path, a low-confidence boundary, a crossing."""
    T = 4
    ego = torch.tensor(np.stack([np.arange(1, T + 1), np.zeros(T)], -1)[None], dtype=torch.float32)
    near = np.stack([np.linspace(0, 5, 5), np.full(5, 0.5)], -1)
    far = np.stack([np.linspace(0, 5, 5), np.full(5, 50.0)], -1)
    lanes = torch.tensor(np.stack([near, far])[None], dtype=torch.float32)
    scores = torch.tensor([[[0, 0, 0.9, 0], [0, 0, 0.9, 0]]])
    d = np.linalg.norm(ego[0].numpy()[:, None] - near[None], axis=-1).min(-1)
    _close(plan_aux.plan_map_bound_loss(ego, lanes, scores)[0], 1.0 - d, "near boundary")
    assert not plan_aux.plan_map_bound_loss(ego, lanes, scores * 0.1).any()
    cross = torch.tensor(np.stack([np.full(5, 2.5), np.linspace(-1, 1, 5)], -1)[None, None],
                         dtype=torch.float32)
    loss = plan_aux.plan_map_bound_loss(ego, cross, torch.tensor([[[0, 0, 0.9, 0]]]))[0]
    assert not loss[2:].any()


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (0.0, 0.0, 0.0)])
def test_wiring_matches_jax(monkeypatch, weights):
    """``loss_plan_aux`` on the outputs of one tiny() frame (the port's,
    handed to both packages), with the weights set on both sides; with all
    three at 0 ``compute_losses`` adds no auxiliary key."""
    for mod in (hipad_loss, jloss):
        for name, w in zip(("PLAN_BOUND_W", "PLAN_COL_W", "PLAN_DIR_W"), weights):
            monkeypatch.setattr(mod, name, w)
    cfg = tiny()
    model = init_random(HiPAD(cfg, device="cpu"), 0)
    batch = synthetic.make_batch(cfg, 2, seed=4)
    images, metas = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        out, _ = model(images, metas)
    # the last layer rewritten so that every regulariser sees elements on
    # both sides of its thresholds: every plan mode drives about 1 m a step
    # along +x, lanes run beside it at -2.5..2.5 m, tilted by up to 0.5 rad
    # (some cross it), agents stand within a few metres, and the scores are
    # confident for about half of each
    rng = np.random.default_rng(7)
    last = lambda a: torch.from_numpy(a.astype(np.float32))
    plan = out["plan"]["prediction"]
    steps = rng.normal(0, 0.1, plan[-1].shape)
    steps[..., 0] += 1.0
    plan[-1] = last(steps)
    lanes = out["map"]["prediction"]
    bs, V = lanes[-1].shape[:2]
    t = np.linspace(-1, 5, cfg.map_num_pts)
    tilt = rng.uniform(-0.5, 0.5, (bs, V, 1))
    y0 = rng.uniform(-2.5, 2.5, (bs, V, 1))
    lanes[-1] = last(np.stack([t * np.cos(tilt), y0 + t * np.sin(tilt)], -1).reshape(bs, V, -1))
    det = out["det"]["prediction"]
    xy = np.stack([rng.uniform(0, 5, det[-1].shape[:2]), rng.uniform(-3, 3, det[-1].shape[:2])], -1)
    det[-1] = torch.cat([last(xy), det[-1][..., 2:]], dim=-1)
    for task in ("map", "det"):
        cls = out[task]["classification"]
        cls[-1] = last(rng.normal(0, 3, cls[-1].shape))
    data = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = hipad_loss.compute_losses(cfg, out, data)
    aux = {"plan_loss_bound", "plan_loss_col", "plan_loss_dir"}
    if not any(weights):
        assert not aux & set(losses)
        return
    assert aux <= set(losses)
    jout = {t: {k: jnp.asarray(v.numpy()) for k, v in d.items() if torch.is_tensor(v)}
            for t, d in out.items()}
    ref = jloss.loss_plan_aux(cfg, jout, {k: jnp.asarray(v) for k, v in batch.items()})
    got = hipad_loss.loss_plan_aux(cfg, out, data)
    assert set(got) == set(ref) == aux
    for k in sorted(ref):
        assert float(ref[k]) > 0, k
        _close(got[k], ref[k], k)
        _close(losses[k], ref[k], f"compute_losses {k}")
