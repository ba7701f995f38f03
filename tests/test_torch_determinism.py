"""Training that repeats itself bit for bit under torch's deterministic flag
(``torch.use_deterministic_algorithms(True)``), on the CPU at ``tiny()``.

On the card the sampler's backward kernels add no float atomics, with the
flag on or off (``hipad_torch/ops/kernels.py``): K1-bwd and K2-bwd bin
their map-gradient items by (map, row, column segment), order the bins with
a stable counting sort and sum each cell's taps in that order
(``csrc/bin_scatter.cuh``); ``chip_smoke.py`` holds the kernels, the
stage-2 steps and the CLI bit for bit there. Here: the plain order
(``bin_order``) against numpy's stable argsort; the plain keys, that order
and the cells' read ranges of the plan, summed as the cells kernel sums
them, against autograd of the plain samplers; the wrappers' calls the same
with the flag on and off; two training steps under the flag from one state
(equal bit for bit, and within ``test_torch_train_step.py``'s tolerances of
the JAX step); and the training CLI run twice from one seed (its logs equal
bit for bit)."""

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


@pytest.mark.parametrize("items, nbins", [(1000, 40), (7, 3), (5000, 4096), (600, 1),
                                          (2000, 20_000), (50, 30_000)])
def test_bin_order_is_a_stable_sort_by_bin(items, nbins):
    """Keys with many repeats and some -1 (items that add nothing): the
    order is numpy's stable argsort of the live items (a bin's items keep
    their own order), and each bin's run starts where numpy's
    ``searchsorted`` says, the last entry at the count of live items; also
    with far more bins than items."""
    rng = np.random.default_rng(items)
    keys = rng.integers(0, nbins, items).astype(np.int32)
    keys[::5] = -1
    order, start = kernels.bin_order(torch.from_numpy(keys), nbins)
    assert order.dtype == torch.int64 and start.dtype == torch.int32
    live = np.flatnonzero(keys >= 0)
    want = live[np.argsort(keys[live], kind="stable")]
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(start.numpy(),
                                  np.searchsorted(keys[want], np.arange(nbins + 1), "left"))
    for k in range(nbins):  # each run: exactly that bin's items, ascending
        run = order.numpy()[start[k]:start[k + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(keys == k))


def _hat(t):
    return (1 - t.abs()).clamp(min=0)


def _cells_plain(plan, sizes, maps, keys, xy, w_rows, up_rows, w, gout, taps):
    """The cells kernel's sums on the CPU: for each run of ``plan.ow`` cells
    of every map row, the items of bin rows r-1 and r over the segments of
    the left tap columns [xa - 1, xb - 1], in ``bin_order``'s order, each
    tap ``taps(x, y, H, W, r)`` gives in the run added as weight * w[w_row,
    group] * gout[up_row] -> the map gradients [maps, H, W, C]."""
    order, start = kernels.bin_order(keys, plan.nbins)
    C, G = gout.shape[1], w.shape[1]
    out = []
    for (H, W), t in zip(sizes, plan.levels):
        d = torch.zeros(maps, H, W, C, dtype=torch.float64)
        for m in range(maps):
            for r in range(H):
                for xa in range(0, W, plan.ow):
                    xb = min(W, xa + plan.ow)
                    for tb in (r - 1, r):
                        ti = tb - t.tb0
                        if not 0 <= ti < t.rowbins:
                            continue
                        brow = t.bin0 + (m * t.rowbins + ti) * t.nseg
                        for e in range(start[brow + max(xa - 1, 0) // t.sw],
                                       start[brow + (xb - 1) // t.sw + 1]):
                            i = order[e]
                            for col, s in taps(*xy[i], H, W, r):
                                if xa <= col < xb and s != 0:
                                    scale = s * w[w_rows[i]].repeat_interleave(C // G)
                                    d[m, r, col] += scale.double() * gout[up_rows[i]].double()
        out.append(d)
    return out


def _k1_taps(x, y, H, W, r):
    x0 = int(torch.floor(x))
    wy = _hat(y - r)
    return [(c, wy * _hat(x - c)) for c in (x0, x0 + 1)]


def _k2_taps(x, y, H, W, r):
    p, q = x * float(W) - 0.5, y * float(H) - 0.5
    sx, sy = torch.floor(p).clamp(0, W - 2), torch.floor(q).clamp(0, H - 2)
    wy = _hat(q - (sy + (r - int(sy))))
    return [(int(sx) + j, wy * _hat(p - (sx + j))) for j in (0, 1)]


@pytest.mark.parametrize("M, counts_per_item", [(60, 16), (200, 16), (200, 0.1)])
def test_k1_bwd_binned_scatter_matches_autograd(M, counts_per_item, monkeypatch):
    """K1-bwd's keys, order and the cells' read ranges of its plan (runs of
    4 cells at 60 samples, single cells at 200; bins of 1 column, or of 4
    where the plan allows 0.1 counts an item) sum every tap of the map gradient that
    autograd of ``interp_matmul_camsum`` gives, on 2 cameras' 5x7 maps,
    coordinates past every border and on integers (the kinks)."""
    from hipad_torch.ops import sampling

    monkeypatch.setattr(kernels, "_BIN_COUNTS_PER_ITEM", counts_per_item)
    g = torch.Generator().manual_seed(M)
    bs, cams, H, W, C, G = 1, 2, 5, 7, 16, 2
    B = bs * cams
    fm = torch.randn(B, H, W, C, generator=g)
    px = torch.rand(B, M, generator=g) * (W + 2) - 1.5
    py = torch.rand(B, M, generator=g) * (H + 2) - 1.5
    px[:, ::7], py[:, ::5] = px[:, ::7].round(), py[:, ::5].round()
    wg = torch.rand(B, M, G, generator=g) * (torch.rand(B, M, 1, generator=g) < 0.6)
    gout = torch.randn(bs, M, C, generator=g)
    leaf = fm.clone().requires_grad_()
    (ref,) = torch.autograd.grad(sampling.interp_matmul_camsum(leaf, px, py, wg, bs, cams), leaf,
                                 gout)
    plan = kernels.k1_bwd_plan(B, H, W, M)
    assert plan.ow == (4 if M == 60 else 1) and plan.levels[0].sw == (1 if counts_per_item > 1 else 4)
    keys = kernels.k1_bin_keys(px, py, wg, H, W, plan)
    i = torch.arange(B * M)
    xy = torch.stack([px.reshape(-1), py.reshape(-1)], -1)
    (got,) = _cells_plain(plan, [(H, W)], B, keys, xy, i, i // (cams * M) * M + i % M,
                          wg.reshape(-1, G), gout.reshape(-1, C), _k1_taps)
    torch.testing.assert_close(got.float(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level_k, counts_per_item", [(None, 16), (None, 1), (1, 16)])
def test_k2_bwd_binned_scatter_matches_autograd(level_k, counts_per_item, monkeypatch):
    """K2-bwd's keys, order and the cells' read ranges of its plan (runs of
    4 cells, both fine levels in one plan, bins of 1 column or of several)
    sum every tap of the map gradients that autograd of
    ``patch_sample_plain`` gives, bs=2, 3 cameras, cam_k 2, and its
    level-k variant (one kept level a slot)."""
    from hipad_torch.ops import sampling

    monkeypatch.setattr(kernels, "_BIN_COUNTS_PER_ITEM", counts_per_item)
    g = torch.Generator().manual_seed(7)
    bs, cams, C, G, M0, cam_k = 2, 3, 16, 2, 15, 2
    sizes = [(6, 8), (4, 5)]
    M = M0 * cam_k
    maps = [torch.randn(bs, cams, h, w, C, generator=g) for h, w in sizes]
    cam = torch.randint(0, cams, (bs, M), generator=g, dtype=torch.int32)
    x = torch.rand(bs, M, generator=g) * 1.2 - 0.1
    y = torch.rand(bs, M, generator=g) * 1.2 - 0.1
    x[:, ::6] = ((x[:, ::6] * 8 - 0.5).round() + 0.5) / 8  # level 0's pixel corners: kinks
    lvl = None
    n = len(sizes)
    if level_k is not None:
        lvl = torch.randint(0, len(sizes), (bs, M, level_k), generator=g, dtype=torch.int32)
        n = level_k
    w = torch.rand(bs, M, n, G, generator=g)
    gout = torch.randn(bs, M0, C, generator=g)
    leaves = [m.clone().requires_grad_() for m in maps]
    ref = torch.autograd.grad(sampling.patch_sample_plain(leaves, cam, x, y, w, cam_k, lvl),
                              leaves, gout)
    plan = kernels.k2_bwd_plan(bs, cams, sizes, M, n)
    assert plan.ow == 4 and plan.levels[0].sw == (1 if counts_per_item > 1 else 4)
    keys = kernels.k2_bin_keys(cam, x, y, cams, sizes, plan, lvl)
    i = torch.arange(bs * M * n)
    s = i // n
    xy = torch.stack([x.reshape(-1), y.reshape(-1)], -1)[s]
    got = _cells_plain(plan, sizes, bs * cams, keys, xy, i, s // M * M0 + s % M // cam_k,
                       w.reshape(-1, G), gout.reshape(-1, C), _k2_taps)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float().reshape(b.shape), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["interp_sample_camsum_bwd", "patch_sample_bwd",
                                  "patch_sample_bwd_lk"])
def test_backward_wrappers_route_by_the_flag(name):
    """K1-bwd, K2-bwd and K2-bwd-lk take one design whatever torch's flag
    says: with the flag off, on and off again a call reaches the same input
    checks and refuses CPU tensors in the same words, never the error torch
    gives where an op has no deterministic implementation."""
    k = getattr(kernels, name)
    seen = []
    for on in (False, True, False):
        with deterministic(on), pytest.raises(ValueError, match="takes CUDA tensors") as err:
            if name == "interp_sample_camsum_bwd":
                k(torch.zeros(6, 4, 4, 16), *[torch.zeros(6, 3)] * 2, torch.zeros(6, 3, 2),
                  torch.zeros(1, 3, 16), 1, 6)
            else:
                lvl = torch.zeros(1, 4, 1, dtype=torch.int32) if name.endswith("_lk") else None
                k([torch.zeros(1, 6, 4, 4, 16)], torch.zeros(1, 4, dtype=torch.int32),
                  *[torch.zeros(1, 4)] * 2, torch.zeros(1, 4, 1, 2), torch.zeros(1, 2, 16), 2,
                  lvl)
        seen.append(str(err.value))
    assert seen[0] == seen[1] == seen[2]
    assert "deterministic" not in seen[0]


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
