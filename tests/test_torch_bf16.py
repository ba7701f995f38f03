"""The port's bf16 (autocast) against the JAX package's bf16
(``HiPAD(cfg, dtype=jnp.bfloat16)``, its default precision) at ``tiny()``,
bs=2, on the CPU: a two-frame episode (frame 2 on the bf16 banks of frame
1) and one training step (on the banks of one fp32 eval frame of the port,
as ``test_torch_train_step.py``'s first step, whose JAX fp32 run this test
shares).

Tolerance, per output: twice JAX's own bf16-against-fp32 spread on the same
inputs, ``max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_fp32|``,
plus the fp32 tolerance (``1e-4 * max|ref| + 1e-5``) for outputs that bf16
barely moves. Two bf16 runs that round in different places differ by about
as much as either differs from fp32, so a port that rounds where JAX rounds
stays inside twice the spread, and one that drops or adds a rounding at a
sensitive place does not (a CPU-only bf16 einsum in the anchors' ego-motion
projection moved the temporal layer's boxes 70 times JAX's spread). Twice
JAX's relative spread of the waypoints on each frame is also the bound that
``chip_smoke.py`` holds the card's bf16 frames to (``BF16_FRAME_RTOL``).

Where autocast's op lists differ between the CPU and the card (softmax,
layer_norm, sum, nearest upsampling), the port casts explicitly
(``models/common.py``), so this CPU run takes the card's arithmetic. The
divergences from JAX kept on purpose, and their sizes, are recorded in
ROADMAP.md queue 3."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import META_KEYS, batch_to_torch
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import to_jax
from hipad_tpu.models import decoder as jdecoder
from hipad_tpu.models.detector import HiPAD as JHiPAD
from hipad_tpu.train import train_step as jts
from test_torch_train_stage1 import to_jax_banks
from test_torch_train_step import _leaves, _NoDropDeformable, _once_per_session, _port, _two_steps

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SPREAD_X = 2.0
RTOL, ATOL = 1e-4, 1e-5


def _check(what, got, ref, ref32):
    got, ref, ref32 = (np.asarray(a, np.float64) for a in (got, ref, ref32))
    assert got.shape == ref.shape == ref32.shape, (what, got.shape, ref.shape, ref32.shape)
    if not ref.size:
        return 0.0
    spread = np.abs(ref - ref32).max()
    err = np.abs(got - ref).max()
    tol = SPREAD_X * spread + RTOL * np.abs(ref).max() + ATOL
    assert err <= tol, (f"{what}: |port_bf16 - jax_bf16| {err:.3e} > {SPREAD_X} x JAX's "
                        f"bf16/fp32 spread {spread:.3e} + fp32 tolerance")
    return err / tol


def _bank_leaves(banks):
    return {f"bank.{n}.{f.name}": getattr(getattr(banks, n), f.name)
            for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))}


def _numpy(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_two_frame_episode_matches_jax_bf16():
    cfg = tiny(decoder_remat=False)
    for frame, (jout, jout32) in enumerate(bf16_episode(cfg)):
        # the smoke holds the card's bf16/fp32 waypoint difference on the
        # same frame (cold banks, then warm) to the spread this test allows
        # there, rounded up by at most a quarter
        wp = _numpy(jout["plan"]["final_waypoints"])
        wp32 = _numpy(jout32["plan"]["final_waypoints"])
        rel = np.abs(wp - wp32).max() / np.abs(wp32).max()
        bound = chip_smoke.BF16_FRAME_RTOL[frame]
        assert SPREAD_X * rel <= bound <= 1.25 * SPREAD_X * rel, (frame, rel, bound)


def bf16_episode(cfg):
    """Two frames of ``cfg`` (bs=2) through the port under bf16 autocast and
    through the JAX package in bf16 and in fp32, on the same weights; every
    float output and bank leaf of the port held to the rule above -> the JAX
    (bf16, fp32) outputs of each frame."""
    batch = synthetic.make_batch(cfg, 2, seed=3)
    model = _port(cfg)
    images, metas = batch_to_torch(batch, "cpu")
    metas2 = dict(metas, timestamp=metas["timestamp"] + 0.5)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        t1, tb1 = model(images, metas)
        t2, tb2 = model(images + 0.1, metas2, tb1)

    variables = jax.tree_util.tree_map(jnp.asarray, to_jax(model.state_dict()))
    jmetas = {k: jnp.asarray(batch[k]) for k in META_KEYS}
    jimages = jnp.asarray(batch["images"])
    jmetas2 = dict(jmetas, timestamp=jmetas["timestamp"] + 0.5)
    runs = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("fp32", None)):
        apply = jax.jit(JHiPAD(cfg, dtype=dtype).apply)
        j1, jb1 = apply(variables, jimages, jmetas)
        j2, jb2 = apply(variables, jimages + 0.1, jmetas2, jb1)
        runs[name] = [(j1, jb1), (j2, jb2)]

    worst = {}
    for frame, (tout, tb) in enumerate(((t1, tb1), (t2, tb2))):
        (jout, jb), (jout32, jb32) = runs["bf16"][frame], runs["fp32"][frame]
        got = {**{f"out.{k}": v for k, v in _leaves(tout)}, **_bank_leaves(tb)}
        ref = {**{f"out.{k}": v for k, v in _leaves(jout)}, **_bank_leaves(jb)}
        ref32 = {**{f"out.{k}": v for k, v in _leaves(jout32)}, **_bank_leaves(jb32)}
        assert set(got) == set(ref), set(got) ^ set(ref)
        for k in sorted(ref):
            if not jnp.issubdtype(ref[k].dtype, jnp.floating):
                continue  # ids and counters: selections that a rounding may flip
            worst[f"frame {frame + 1} {k}"] = _check(f"frame {frame + 1} {k}", _numpy(got[k]),
                                                     _numpy(ref[k]), _numpy(ref32[k]))
    assert len(worst) > 20
    return [(runs["bf16"][f][0], runs["fp32"][f][0]) for f in range(2)]


@pytest.fixture(scope="module")
def fp32_runs(tmp_path_factory):
    """``test_torch_train_step.py``'s two chained fp32 steps of both
    packages, computed once per session."""
    return _once_per_session(tmp_path_factory, "torch_train_step_runs", _two_steps)


def test_training_step_matches_jax_bf16(fp32_runs):
    """The first step of ``test_torch_train_step.py`` in bf16 on both sides:
    every loss and the gradient norm within twice JAX's bf16/fp32 spread
    (JAX's fp32 values from that file's shared run)."""
    cfg = tiny(drop_out=0.0, use_grid_mask=False, decoder_remat=False)
    batch = synthetic.make_batch(cfg, 2, seed=3)
    model = _port(cfg)
    images, metas = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        _, banks = model(images, metas)
    step_batch = dict(batch, timestamp=batch["timestamp"] + 0.5)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdecoder, "DeformableAggregation", _NoDropDeformable)
    try:
        jm = JHiPAD(cfg, dtype=jnp.bfloat16)
        variables = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                           to_jax(model.state_dict()))
        loss_fn = jts._make_loss_fn(cfg, jm, True)

        @jax.jit
        def jstep(banks, batch):
            (total, (losses, _, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                variables["params"], variables["batch_stats"], banks, batch,
                jax.random.PRNGKey(0))
            return dict(losses, total_loss=total, grad_norm=optax.global_norm(grads))

        ref = {k: float(v) for k, v in jstep(
            to_jax_banks(banks), jax.tree_util.tree_map(jnp.asarray, step_batch)).items()}
    finally:
        mp.undo()
    _, metrics = make_train_step(cfg, model, AdamW(model.named_parameters()),
                                 dtype=torch.bfloat16)(
        banks, {k: torch.as_tensor(v) for k, v in step_batch.items()},
        torch.Generator().manual_seed(0))
    ref32 = fp32_runs[0]["jax"]["metrics"]
    assert set(metrics) == set(ref) == set(ref32)
    for k in sorted(ref):
        _check(f"step {k}", float(metrics[k]), ref[k], ref32[k])
