"""The port's training step against ``hipad_tpu.train.train_step`` at
``tiny()``: two chained steps, bs=2, fp32 on the CPU, the same weights
(the port's seeded init with random norms and running statistics, carried
to flax with ``to_jax``). Both packages start from the same banks, those
of one eval frame of the port, so that both steps take the temporal path
and the JAX step compiles once; step 2 takes the banks each package's
step 1 returned.

Dropout and GridMask are off on both sides (``drop_out=0``,
``use_grid_mask=False``, and the deformable ``attn_drop``, which the JAX
decoder fixes at 0.15 whatever ``drop_out`` says, set to 0 in both), so
that the two steps are deterministic functions of the same inputs.

The JAX side runs the body of ``make_train_step`` (``value_and_grad`` of
its loss closure ``_make_loss_fn``, ``TrainState.apply_gradients``,
``optax.global_norm``) as one jitted function that also returns the
gradients, so that each bank variant compiles once. Step 2 starts both packages from the JAX parameters after
step 1: AdamW's first update is about ``lr * sign(g)``, so a gradient near
zero that rounds to the other sign moves its parameter by ``2 lr``. The
update itself is held to optax with the same gradients in
``test_torch_train_losses.py``; here the parameters after step 1 are held
within that ``2 lr``.
"""

import dataclasses
import fcntl
import os
import pickle
import time
import types
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipad_tpu.models import decoder as jdecoder
from hipad_tpu.models import instance_bank as jib
from hipad_tpu.models.deformable import DeformableAggregation as JDeformable
from hipad_tpu.models.detector import HiPAD as JHiPAD
from hipad_tpu.train import optim as jopt
from hipad_tpu.train import train_step as jts
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.common import BatchNorm, Scale
from hipad_torch.models.deformable import DeformableAggregation
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.train.optim import AdamW, lr_at
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import from_jax, init_random, to_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# Losses: the same fp32 arithmetic through a ResNet and two decoder layers,
# summed in other orders on the two sides (seen: <= 2e-6 of the value):
# |diff| <= RTOL * |ref| + ATOL.
RTOL, ATOL = 1e-4, 1e-5
# The gradient norm: step 2 runs on banks carried from step 1, which already
# differ in the fifth digit, through a loss twenty times steeper (norm ~6e3;
# seen: 1.3e-4 of the value): |diff| <= GRAD_NORM_RTOL * |ref|.
GRAD_NORM_RTOL = 1e-3
# Each gradient leaf against the largest value of that leaf, plus a floor
# of GRAD_FLOOR times the largest gradient of the model: backward sums over
# every query and sample run in another order, and some gradients are
# zero but for rounding (a key projection's bias, which the softmax
# cancels), so their noise has the size of the other leaves' rounding
# (seen: <= 8e-4 of the leaf with that floor).
LEAF_RTOL, GRAD_FLOOR = 2e-3, 1e-6
# Running statistics and banks against the largest value of each (seen:
# <= 2e-5).
STATE_RTOL = 2e-4


class _NoDropDeformable(JDeformable):
    attn_drop: float = 0.0


def _leaves(tree, prefix=""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _port(cfg, seed=0):
    model = init_random(HiPAD(cfg, device="cpu"), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, BatchNorm, Scale)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
            if isinstance(m, BatchNorm):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
            if isinstance(m, DeformableAggregation):
                m.attn_drop = 0.0
    return model


def _bank_dict(banks):
    return {f"{n}.{f.name}": getattr(getattr(banks, n), f.name)
            for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))}


# How long a pytest-xdist worker waits for the one that computes the runs
# before it computes them itself (alone the computation takes about 2 min).
SHARED_WAIT_S = 900


def _once_per_session(tmp_path_factory, name, compute):
    """``compute()`` once per test session: under pytest-xdist the first
    worker to take a file lock computes and pickles the result into the
    session's temporary directory, and the others wait for the lock and load
    it. A worker that fails to compute leaves no file, so the next one tries
    itself; one that waits longer than ``SHARED_WAIT_S`` computes its own.
    Without xdist it just computes."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return compute()
    root = tmp_path_factory.getbasetemp().parent  # shared by the session's workers
    path = root / f"{name}-{uid}.pkl"
    with open(root / f"{name}-{uid}.lock", "w") as lock:
        deadline = time.monotonic() + SHARED_WAIT_S
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    return compute()
                time.sleep(0.5)
        if path.exists():
            return pickle.loads(path.read_bytes())
        result = compute()
        tmp = path.with_name(f"{path.name}.{os.getpid()}")
        tmp.write_bytes(pickle.dumps(result))
        os.replace(tmp, path)
        return result  # closing the file releases the lock


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages, two chained steps, computed once per session ->
    per step: port (metrics, grads, batch_stats, banks, params), JAX the
    same, all numpy."""
    return _once_per_session(tmp_path_factory, "torch_train_step_runs", _two_steps)


def _two_steps():
    mp = pytest.MonkeyPatch()
    mp.setattr(jdecoder, "DeformableAggregation", _NoDropDeformable)
    try:
        cfg = tiny(drop_out=0.0, use_grid_mask=False, decoder_remat=False)
        batch = synthetic.make_batch(cfg, 2, seed=3)
        model = _port(cfg)
        opt = AdamW(model.named_parameters())
        step = make_train_step(cfg, model, opt)

        jm = JHiPAD(cfg)
        # jnp.array(np.array(.)): never share memory with the port's tensors,
        # whose running statistics the port's step updates in place
        variables = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)),
                                           to_jax(model.state_dict()))
        tx = jopt.make_optimizer()
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]), tx=tx)
        loss_fn = jts._make_loss_fn(cfg, jm, True)

        @jax.jit
        def jstep(state, banks, batch, rng):
            (total, (losses, new_banks, new_bs)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params, state.batch_stats, banks, batch, rng)
            metrics = dict(losses, total_loss=total, grad_norm=optax.global_norm(grads))
            return (state.apply_gradients(grads).replace(batch_stats=new_bs), new_banks,
                    metrics, grads)

        rng = jax.random.PRNGKey(0)
        gen = torch.Generator().manual_seed(0)

        images, metas = batch_to_torch(batch, "cpu")
        with torch.no_grad():
            _, tbanks = model(images, metas)
        jbanks = jib.BankStates(**{
            n: getattr(jib, f"{n.capitalize()}BankState")(**{
                f.name: jnp.array(getattr(getattr(tbanks, n), f.name).numpy())
                for f in dataclasses.fields(getattr(tbanks, n))})
            for n in ("det", "ego", "plan")})
        out = []
        for i in range(2):
            b = dict(batch, timestamp=batch["timestamp"] + 0.5 * (i + 1))
            jb = jax.tree_util.tree_map(jnp.asarray, b)
            state, jbanks, jmetrics, grads = jstep(state, jbanks, jb, rng)
            tbanks, tmetrics = step(tbanks, {k: torch.as_tensor(v) for k, v in b.items()}, gen)
            # copies: to_jax's arrays share memory with the tensors, which the
            # load_state_dict below overwrites
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            tgrads = to_jax({n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                             for n, p in model.named_parameters()})["params"]
            out.append({
                "port": {"metrics": {k: float(v) for k, v in tmetrics.items()},
                         "grads": dict(_leaves(tgrads)),
                         "batch_stats": dict(_leaves(to_jax(sd)["batch_stats"])),
                         "params": dict(_leaves(to_jax(sd)["params"])),
                         "banks": {k: v.numpy().copy() for k, v in _bank_dict(tbanks).items()}},
                "jax": {"metrics": {k: float(v) for k, v in jmetrics.items()},
                        "grads": {k: np.asarray(v) for k, v in _leaves(grads)},
                        "batch_stats": {k: np.asarray(v) for k, v in
                                        _leaves(state.batch_stats)},
                        "params": {k: np.asarray(v) for k, v in _leaves(state.params)},
                        "banks": {k: np.asarray(v) for k, v in _bank_dict(jbanks).items()}},
                "lr": lr_at(i),
            })
            # step 2 starts from the same parameters and running statistics
            with torch.no_grad():
                model.load_state_dict(from_jax(jax.tree_util.tree_map(
                    np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
        return out
    finally:
        mp.undo()


def _close(name, got, ref, rtol, scale=None, atol=ATOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max() if scale is None else scale
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= rtol * scale + atol, \
        f"{name}: max_abs_err {err:.3e} > {rtol} x {scale:.3e} + {atol:.1e}"


@pytest.mark.parametrize("i", [0, 1])
def test_losses_and_grad_norm(runs, i):
    port, ref = runs[i]["port"]["metrics"], runs[i]["jax"]["metrics"]
    assert set(port) == set(ref), set(port) ^ set(ref)
    for k in sorted(ref):
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else RTOL
        _close(f"step {i + 1} {k}", port[k], ref[k], rtol, abs(ref[k]))


@pytest.mark.parametrize("i", [0, 1])
def test_every_gradient_leaf(runs, i):
    port, ref = runs[i]["port"]["grads"], runs[i]["jax"]["grads"]
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))[:10]
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in ref.values() if v.size)
    for k in sorted(ref):
        _close(f"step {i + 1} grad {k}", port[k], ref[k], LEAF_RTOL, atol=floor)


@pytest.mark.parametrize("i", [0, 1])
def test_batch_stats(runs, i):
    port, ref = runs[i]["port"]["batch_stats"], runs[i]["jax"]["batch_stats"]
    assert set(port) == set(ref)
    for k in sorted(ref):
        _close(f"step {i + 1} batch_stats {k}", port[k], ref[k], STATE_RTOL)


@pytest.mark.parametrize("i", [0, 1])
def test_carried_banks(runs, i):
    port, ref = runs[i]["port"]["banks"], runs[i]["jax"]["banks"]
    assert set(port) == set(ref)
    for k in sorted(ref):
        if np.issubdtype(ref[k].dtype, np.integer):
            np.testing.assert_array_equal(port[k], ref[k], err_msg=f"step {i + 1} bank {k}")
        else:
            _close(f"step {i + 1} bank {k}", port[k], ref[k], STATE_RTOL)


def test_params_after_the_first_update(runs):
    """Within 2 lr of optax's update (a near-zero gradient may round to the
    other sign, see the module docstring), plus fp32 rounding."""
    port, ref = runs[0]["port"]["params"], runs[0]["jax"]["params"]
    assert set(port) == set(ref)
    lr = runs[0]["lr"]
    for k in sorted(ref):
        err = np.abs(port[k].astype(np.float64) - ref[k]).max()
        assert err <= 2 * lr * 1.001 + 1e-6, f"param {k}: {err:.3e}"


def test_training_leaves_the_config_untouched():
    """The anchors are parameters copied from the config, not views of its
    arrays: a step's update must not reach back into ``cfg``."""
    cfg = tiny()
    before = {n: np.array(getattr(cfg, n)) for n in ("det_anchor", "map_anchor",
                                                      "plan_anchor", "motion_anchor")}
    model = init_random(HiPAD(cfg, device="cpu"), 0)
    batch = {k: torch.as_tensor(v) for k, v in synthetic.make_batch(cfg, 1).items()}
    make_train_step(cfg, model, AdamW(model.named_parameters()))(
        None, batch, torch.Generator().manual_seed(0))
    assert not torch.equal(model.decoder.det_anchor, torch.from_numpy(before["det_anchor"]))
    for n, v in before.items():
        np.testing.assert_array_equal(getattr(cfg, n), v, err_msg=n)


def test_runs_are_computed_once_per_session(tmp_path, monkeypatch):
    """Workers that ask for the shared runs at once: one computes, every one
    gets its result; a computation that raises leaves the next to compute."""
    monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", "stress")
    factory = types.SimpleNamespace(getbasetemp=lambda: tmp_path / "popen-gw0")
    calls = []

    def compute():
        calls.append(1)
        time.sleep(0.3)
        return {"x": np.arange(3)}

    with ThreadPoolExecutor(16) as ex:
        futures = [ex.submit(_once_per_session, factory, "stress", compute) for _ in range(16)]
        results = [f.result(timeout=120) for f in futures]
    assert len(calls) == 1
    for r in results:
        np.testing.assert_array_equal(r["x"], np.arange(3))

    def failing():
        raise RuntimeError("no runs")

    with pytest.raises(RuntimeError, match="no runs"):
        _once_per_session(factory, "failing", failing)
    assert _once_per_session(factory, "failing", lambda: 7) == 7
