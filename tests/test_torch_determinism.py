"""Training that repeats itself bit for bit under torch's deterministic flag
(``torch.use_deterministic_algorithms(True)``), on the CPU at ``tiny()``.

On the card the flag sends the sampler's backward wrappers to their
deterministic routes (``hipad_torch/ops/kernels.py``: ``pick_route``), and
K2-bwd's deterministic route orders its map-gradient items by cell with
``contribution_index``; ``chip_smoke.py`` holds the kernels, the stage-2
steps and the CLI bit for bit there. Here: that index against numpy's
stable argsort, the route choice as a pure function of the flag, two
training steps under the flag from one state (equal bit for bit, and within
``test_torch_train_step.py``'s tolerances of the JAX step), and the training
CLI run twice from one seed (its logs equal bit for bit)."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.ops import kernels
from hipad_torch.tools import train
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from test_torch_train_stage1 import (NO_DROP, assert_step_matches, port_result, step_batch,
                                     warm_banks)
from test_torch_train_step import _port, runs  # noqa: F401 (runs: the shared JAX steps)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def deterministic(on: bool):
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("items, cells", [(1000, 40), (7, 3), (5000, 4096)])
def test_contribution_index_is_a_stable_argsort_of_the_keys(items, cells):
    """Keys with many repeats and some ``cells`` (items that add nothing):
    the order is numpy's stable argsort (a cell's items keep their own
    order), and each cell's run starts where numpy's ``searchsorted``
    says, the last entry at the first item that adds nothing."""
    rng = np.random.default_rng(items)
    keys = rng.integers(0, cells + 1, items).astype(np.int32)
    keys[::5] = cells
    order, starts = kernels.contribution_index(torch.from_numpy(keys), cells)
    assert order.dtype == torch.int64 and starts.dtype == torch.int32
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(starts.numpy(),
                                  np.searchsorted(keys[want], np.arange(cells + 1), "left"))
    for c in range(cells):  # each run: exactly that cell's items, ascending
        run = order.numpy()[starts[c]:starts[c + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(keys == c))


ATOMIC, DET = kernels.Route("atomic", atomic=True), kernels.Route("pull", atomic=False)


@pytest.mark.parametrize("routes, off, on", [
    ((ATOMIC, DET), ATOMIC, DET),   # a fast atomic design kept beside a deterministic one
    ((DET, ATOMIC), DET, DET),
    ((DET,), DET, DET),             # one deterministic design, no dispatch
    ((ATOMIC,), ATOMIC, None),      # no deterministic design: raises under the flag
])
def test_route_choice_is_a_function_of_the_flag(routes, off, on):
    assert kernels.pick_route("K9 example", routes, False) == off
    if on is None:
        with pytest.raises(RuntimeError, match="K9 example does not have a deterministic"):
            kernels.pick_route("K9 example", routes, True)
    else:
        assert kernels.pick_route("K9 example", routes, True) == on


@pytest.mark.parametrize("name", ["interp_sample_camsum_bwd", "patch_sample_bwd",
                                  "patch_sample_bwd_lk"])
def test_backward_wrappers_route_by_the_flag(name, monkeypatch):
    """K1-bwd, K2-bwd and K2-bwd-lk: each call launches ``route()``'s
    choice, read from torch's flag at the call: the deterministic route
    under it, the first route without."""
    k = getattr(kernels, name)
    seen = []
    monkeypatch.setattr(k, "launch", lambda route, *a: seen.append(route))
    for on in (False, True, False):
        with deterministic(on):
            k("inputs")
    assert seen == [k.routes[0], next(r for r in k.routes if not r.atomic), k.routes[0]]


def _state(model, opt):
    return ({k: v.detach().clone() for k, v in model.state_dict().items()}, opt.state_dict())


def test_two_steps_under_the_flag_repeat_bit_for_bit_and_match_jax(runs):  # noqa: F811
    """``test_torch_train_step.py``'s first step (tiny(), bs=2, fp32, no
    dropout or GridMask, warm banks) under the flag, twice from one saved
    state: losses, gradient leaves, running statistics, banks and the
    parameters after the update equal bit for bit; and the first within that
    module's tolerances of the JAX step from the same state."""
    cfg = tiny(**NO_DROP)
    batch = synthetic.make_batch(cfg, 2, seed=3)
    model = _port(cfg)
    opt = AdamW(model.named_parameters())
    step = make_train_step(cfg, model, opt)
    banks = warm_banks(model, batch)
    params, opt_state = _state(model, opt)
    data = {k: torch.as_tensor(v) for k, v in step_batch(batch).items()}
    got = []
    with deterministic(True):
        for _ in range(2):
            model.load_state_dict(params)
            opt.load_state_dict(opt_state)
            new_banks, metrics = step(banks, data, torch.Generator().manual_seed(0))
            got.append(port_result(model, metrics, new_banks))
    a, b = got
    assert a["metrics"] == b["metrics"]
    for part in ("grads", "batch_stats", "banks", "params"):
        assert set(a[part]) == set(b[part])
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), f"{part} {k}"
    assert_step_matches(a, runs[0]["jax"], "under the flag: ")


CLI = ["--device", "cpu", "--tiny", "--synthetic", "2", "--batch-size", "1",
       "--log-interval", "1", "--seed", "3"]


def _log(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "ips")}
                for line in f]


def test_training_cli_repeats_itself_bit_for_bit(tmp_path, monkeypatch):
    """``python -m hipad_torch.tools.train --device cpu --tiny --synthetic 2``
    twice with one seed, once in this process and once as its own: every
    logged loss, ``total_loss`` and ``grad_norm`` equal bit for bit (``time``
    and ``ips`` are clock readings). In this process ``main`` set
    ``CUBLAS_WORKSPACE_CONFIG``, which was absent, and left torch's flag as it
    found it."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with deterministic(False):
        here = train.main(CLI + ["--work-dir", str(tmp_path / "a")])
        assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    res = subprocess.run([sys.executable, "-m", "hipad_torch.tools.train", *CLI,
                          "--work-dir", str(tmp_path / "b")], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(env, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    a, b = _log(tmp_path / "a"), _log(tmp_path / "b")
    assert [m["iter"] for m in a] == [1, 2] and len(here["metrics"]) == 2
    assert a == b
