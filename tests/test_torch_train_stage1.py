"""Stage 1 (``configs.model.stage1``: no motion task, one plan anchor type)
in the port against the JAX package at ``tiny()`` with stage 1's
``task_select`` and plan anchors, fp32 on the CPU: a two-frame episode
(frame 2 on the banks of frame 1) and one training step on the banks of an
eval frame,
with the tolerances of ``test_torch_train_step.py`` (losses, gradient norm,
every gradient leaf, running statistics, banks, parameters within 2 lr).

The JAX side of a step (``jax_step``) runs the body of ``make_train_step``
or ``make_accum_train_step`` jitted from the port's weights; the data
parallel test uses it too. Dropout and GridMask are off on both sides, as
in ``test_torch_train_step.py``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import META_KEYS, batch_to_torch
from hipad_torch.train.optim import AdamW, lr_at
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import to_jax
from hipad_tpu.models import decoder as jdecoder
from hipad_tpu.models import instance_bank as jib
from hipad_tpu.models.detector import HiPAD as JHiPAD
from hipad_tpu.train import optim as jopt
from hipad_tpu.train import train_step as jts
from test_torch_train_step import (ATOL, GRAD_FLOOR, GRAD_NORM_RTOL, LEAF_RTOL, RTOL,
                                   STATE_RTOL, _close, _leaves, _NoDropDeformable, _port)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

STAGE1 = dict(task_select=("det", "map", "plan", "ego"), plan_anchor_types=(("temp", "2hz"),),
              plan_anchor_refer=("temp", "2hz"), plan_speed_refer=("temp", "2hz"))
NO_DROP = dict(drop_out=0.0, use_grid_mask=False, decoder_remat=False)


def bank_dict(banks):
    return {f"{n}.{f.name}": np.asarray(getattr(getattr(banks, n), f.name))
            for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))}


def to_jax_banks(banks):
    """The port's ``BankStates`` -> the JAX package's (fresh arrays)."""
    return jib.BankStates(**{
        n: getattr(jib, f"{n.capitalize()}BankState")(**{
            f.name: jnp.array(getattr(getattr(banks, n), f.name).numpy())
            for f in dataclasses.fields(getattr(banks, n))})
        for n in ("det", "ego", "plan")})


def warm_banks(model, batch):
    """The banks of one eval frame of the port on ``batch``: a step on them
    takes the temporal path. (From cold banks, all-zero instance features
    tie the Hungarian costs, and scipy and JAX may pick different optima of
    equal cost; ROADMAP queue 3, "Ties".)"""
    images, metas = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        return model(images, metas)[1]


def step_batch(batch):
    """The step's batch: half a second after the warm frame's."""
    return dict(batch, timestamp=batch["timestamp"] + 0.5)


def jax_step(cfg, state_dict, batch, banks, accum=0):
    """One JAX training step from the port's ``state_dict`` and ``banks`` on
    the numpy ``batch`` (``accum``: lists of that many micro-batches and
    bank slices) -> numpy ``{"metrics", "params", "batch_stats", "banks"}``
    (and ``"grads"`` without accumulation)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdecoder, "DeformableAggregation", _NoDropDeformable)
    try:
        jm = JHiPAD(cfg)
        variables = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), to_jax(state_dict))
        tx = jopt.make_optimizer()
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]), tx=tx)
        rng = jax.random.PRNGKey(0)
        if accum:
            stack = lambda *xs: jnp.stack([jnp.asarray(x) for x in xs])
            jb = jax.tree_util.tree_map(stack, *batch)
            jk = jax.tree_util.tree_map(stack, *[to_jax_banks(b) for b in banks])
            state, new_banks, metrics = jax.jit(jts.make_accum_train_step(cfg, jm, accum))(
                state, jk, jb, rng)
            grads = None
        else:
            loss_fn = jts._make_loss_fn(cfg, jm, True)

            @jax.jit
            def step(state, banks, batch):
                (total, (losses, nb, bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    state.params, state.batch_stats, banks, batch, rng)
                metrics = dict(losses, total_loss=total, grad_norm=optax.global_norm(grads))
                return state.apply_gradients(grads).replace(batch_stats=bs), nb, metrics, grads

            state, new_banks, metrics, grads = step(
                state, to_jax_banks(banks), jax.tree_util.tree_map(jnp.asarray, batch))
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": {k: np.asarray(v) for k, v in _leaves(state.params)},
               "batch_stats": {k: np.asarray(v) for k, v in _leaves(state.batch_stats)}}
        if accum:
            out["banks"] = [bank_dict(jax.tree_util.tree_map(lambda x: x[a], new_banks))
                            for a in range(accum)]
        else:
            out["banks"] = bank_dict(new_banks)
            out["grads"] = {k: np.asarray(v) for k, v in _leaves(grads)}
        return out
    finally:
        mp.undo()


def port_result(model, metrics, banks, with_grads=True):
    """The port's side of ``jax_step``'s result, after its step."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    jv = to_jax(sd)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": dict(_leaves(jv["params"])),
           "batch_stats": dict(_leaves(jv["batch_stats"])),
           "banks": ([bank_dict(b) for b in banks] if isinstance(banks, list)
                     else bank_dict(banks))}
    if with_grads:
        out["grads"] = dict(_leaves(to_jax({
            n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
            for n, p in model.named_parameters()})["params"]))
    return out


def assert_step_matches(got, ref, what=""):
    """``test_torch_train_step.py``'s tolerances, leaf by leaf."""
    assert set(got["metrics"]) == set(ref["metrics"]), set(got["metrics"]) ^ set(ref["metrics"])
    for k, v in ref["metrics"].items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else RTOL
        _close(f"{what}{k}", got["metrics"][k], v, rtol, abs(v))
    if "grads" in got and "grads" in ref:
        floor = GRAD_FLOOR * max(np.abs(v).max() for v in ref["grads"].values() if v.size)
        for k, v in ref["grads"].items():
            _close(f"{what}grad {k}", got["grads"][k], v, LEAF_RTOL, atol=floor)
    for k, v in ref["batch_stats"].items():
        _close(f"{what}batch_stats {k}", got["batch_stats"][k], v, STATE_RTOL)
    banks = ref["banks"] if isinstance(ref["banks"], list) else [ref["banks"]]
    gbanks = got["banks"] if isinstance(got["banks"], list) else [got["banks"]]
    for gb, rb in zip(gbanks, banks, strict=True):
        for k, v in rb.items():
            if np.issubdtype(v.dtype, np.integer):
                np.testing.assert_array_equal(gb[k], v, err_msg=f"{what}bank {k}")
            else:
                _close(f"{what}bank {k}", gb[k], v, STATE_RTOL)
    lr = lr_at(0)
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        err = np.abs(got["params"][k].astype(np.float64) - v).max()
        assert err <= 2 * lr * 1.001 + 1e-6, f"{what}param {k}: {err:.3e}"


def test_stage1_episode_matches_jax():
    cfg = tiny(**STAGE1, decoder_remat=False)
    assert "motion" not in cfg.task_select and len(cfg.plan_anchor_types) == 1
    batch = synthetic.make_batch(cfg, 2, seed=3)
    model = _port(cfg)
    images, metas = batch_to_torch(batch, "cpu")
    metas2 = dict(metas, timestamp=metas["timestamp"] + 0.5)
    with torch.no_grad():
        t1, tb1 = model(images, metas)
        t2, tb2 = model(images + 0.1, metas2, tb1)
    assert "motion" not in t1
    jm = JHiPAD(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax(model.state_dict()))
    jmetas = {k: jnp.asarray(batch[k]) for k in META_KEYS}
    apply = jax.jit(jm.apply)
    j1, jb1 = apply(variables, jnp.asarray(batch["images"]), jmetas)
    j2, jb2 = apply(variables, jnp.asarray(batch["images"]) + 0.1,
                    dict(jmetas, timestamp=jmetas["timestamp"] + 0.5), jb1)
    for frame, (tout, jout, tb, jb) in enumerate(((t1, j1, tb1, jb1), (t2, j2, tb2, jb2))):
        jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jout)))
        tl = {k: v.numpy() for k, v in _leaves(tout)}
        assert set(tl) == set(jl), set(tl) ^ set(jl)
        pairs = [(f"out.{k}", tl[k], jl[k]) for k in jl]
        jbank = bank_dict(jb)
        pairs += [(f"bank.{k}", v, jbank[k]) for k, v in bank_dict(tb).items()]
        for name, got, ref in pairs:
            if np.issubdtype(ref.dtype, np.integer) or ref.dtype == bool:
                np.testing.assert_array_equal(got, ref, err_msg=f"frame {frame + 1} {name}")
            else:
                _close(f"frame {frame + 1} {name}", got, ref, RTOL, atol=ATOL)


def test_stage1_training_step_matches_jax():
    cfg = tiny(**STAGE1, **NO_DROP)
    batch = synthetic.make_batch(cfg, 2, seed=5)
    model = _port(cfg)
    banks = warm_banks(model, batch)
    batch = step_batch(batch)
    ref = jax_step(cfg, model.state_dict(), batch, banks)
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    banks, metrics = step(banks, {k: torch.as_tensor(v) for k, v in batch.items()},
                          torch.Generator().manual_seed(0))
    got = port_result(model, metrics, banks)
    assert not any(k.startswith("motion") for k in got["metrics"])
    assert_step_matches(got, ref, "stage 1 ")
