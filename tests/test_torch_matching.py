"""The port's batched assignment (``hipad_torch/targets/matching.py``) on the
CPU, where it runs ``assign_plain``, K3's plain version: against JAX's
on-device Jonker-Volgenant ``assign`` where the optimum is unique, and
against scipy's ``linear_sum_assignment`` (the optimality oracle, which the
port no longer imports) on every case: planted ties, NaN and infinite
entries, all-invalid matrices, more valid rows than columns, and the det
and map shapes of a stage-2 training step at a reduced count."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from hipad_tpu.targets import matching as jmatching
from hipad_torch.ops import kernels
from hipad_torch.targets import matching as tmatching

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the totals of two optimal assignments, summed in float64 from the same
# fp32 costs in another order: |diff| <= TOTAL_RTOL * sum |assigned costs|
TOTAL_RTOL = 1e-9


def _sanitised(cost):
    return np.clip(np.nan_to_num(cost.astype(np.float64), nan=1e3, posinf=1e3, neginf=-1e3),
                   -1e3, 1e3)


def _check_optimal(cost, mask, col4row):
    """Every valid row on a distinct real column where it fits, every
    invalid row -1, and each matrix's total equal to scipy's optimum."""
    cost, col4row = _sanitised(cost), np.asarray(col4row)
    n, R, C = cost.shape
    for b in range(n):
        assert (col4row[b][~mask[b]] == -1).all()
        rows = np.flatnonzero(mask[b])
        got = col4row[b][rows]
        assert (got >= 0).sum() == min(len(rows), C)
        taken = got[got >= 0]
        assert len(set(taken.tolist())) == len(taken) and (taken < C).all()
        if not len(rows):
            continue
        r, c = linear_sum_assignment(cost[b, rows])
        ref = cost[b, rows][r, c]
        mine = cost[b, rows[got >= 0], taken]
        assert abs(mine.sum() - ref.sum()) <= TOTAL_RTOL * np.abs(ref).sum() + 1e-12, \
            (b, mine.sum(), ref.sum())


def _both(cost, mask):
    got = tmatching.assign(torch.from_numpy(cost), torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == mask.shape
    return got.numpy()


@pytest.mark.parametrize("shape", [(4, 9, 23), (3, 5, 5), (2, 12, 40)])
def test_assign_plain_equals_jax_assign(shape):
    """Continuous random costs (a unique optimum): the same col4row as
    JAX's solver, and scipy's total."""
    rng = np.random.default_rng(sum(shape))
    cost = rng.uniform(-5, 50, shape).astype(np.float32)
    mask = rng.uniform(size=shape[:2]) < 0.7
    got = _both(cost, mask)
    np.testing.assert_array_equal(got, np.asarray(jmatching.assign(jnp.asarray(cost),
                                                                   jnp.asarray(mask))))
    _check_optimal(cost, mask, got)


def _planted(seed):
    """Costs on a coarse grid (many exact ties), NaN and +-inf entries, one
    all-invalid matrix and one all-valid: [4, 8, 20]."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 4, (4, 8, 20)).astype(np.float32)
    cost[0, 1, 3] = np.nan
    cost[0, 2, :5] = np.inf
    cost[1, 4, 7] = -np.inf
    cost[1, 5, 2] = 5e3  # clipped to 1e3
    mask = rng.uniform(size=(4, 8)) < 0.6
    mask[2] = False
    mask[3] = True
    return cost, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_planted_ties_nan_inf_and_invalid_rows(seed):
    cost, mask = _planted(seed)
    got = _both(cost, mask)
    _check_optimal(cost, mask, got)
    assert (got[2] == -1).all()
    # the same problem one matrix at a time gives the same rows
    for b in range(len(cost)):
        np.testing.assert_array_equal(_both(cost[b:b + 1], mask[b:b + 1])[0], got[b])


def test_more_valid_rows_than_columns():
    """32 valid GT rows for 12 predictions (tiny()'s det anchors): 12 rows
    on real columns, the rest -1, at scipy's optimum, which JAX's fp32
    solver can miss (ROADMAP queue 3, "Ties")."""
    rng = np.random.default_rng(3)
    cost = rng.uniform(0, 30, (3, 32, 12)).astype(np.float32)
    mask = np.ones((3, 32), bool)
    mask[1, 20:] = False
    got = _both(cost, mask)
    _check_optimal(cost, mask, got)
    assert ((got >= 0).sum(1) == [12, 12, 12]).all()


@pytest.mark.parametrize("kind,shape", [("det", (2, 32, 900)), ("map", (2, 24, 100))])
def test_stage2_step_shapes(kind, shape):
    """A stage-2 step's det and map matrices (two of the 6·bs of each):
    equal to JAX's where the optimum is unique, scipy's total."""
    rng = np.random.default_rng(len(kind))
    cost = rng.uniform(0, 20, shape).astype(np.float32)
    mask = np.arange(shape[1])[None] < np.array([[shape[1] // 3], [shape[1]]])
    got = _both(cost, mask)
    np.testing.assert_array_equal(got, np.asarray(jmatching.assign(jnp.asarray(cost),
                                                                   jnp.asarray(mask))))
    _check_optimal(cost, mask, got)


def test_assign_on_the_cpu_takes_the_plain_route(monkeypatch):
    """A CPU tensor runs ``assign_plain``; K3 is never called for it, and
    ``assign_many`` solves each problem as ``assign`` does."""
    calls = []
    plain = tmatching.assign_plain

    def recording(cost, mask):
        calls.append(cost.shape)
        return plain(cost, mask)

    monkeypatch.setattr(tmatching, "assign_plain", recording)
    before = kernels.lsa_assign.launches
    cost, mask = _planted(4)
    a, b = tmatching.assign_many([(torch.from_numpy(cost), torch.from_numpy(mask)),
                                  (torch.from_numpy(cost[:2, :3]), torch.from_numpy(mask[:2, :3]))])
    assert calls == [cost.shape, (2, 3, 20)]
    assert kernels.lsa_assign.launches == before
    np.testing.assert_array_equal(a.numpy(), plain(torch.from_numpy(cost),
                                                   torch.from_numpy(mask)).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lsa_assign(torch.from_numpy(cost), torch.from_numpy(mask))


_NO_SCIPY = r"""
import sys
sys.modules["scipy"] = None  # any import of scipy now raises ImportError
import importlib, pkgutil, torch
import hipad_torch
for m in pkgutil.walk_packages(hipad_torch.__path__, "hipad_torch."):
    importlib.import_module(m.name)
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import HiPAD
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import init_random
cfg = tiny()
model = init_random(HiPAD(cfg, device="cpu"), 0)
batch = {k: torch.as_tensor(v) for k, v in synthetic.make_batch(cfg, 1).items()}
_, metrics = make_train_step(cfg, model, AdamW(model.named_parameters()))(
    None, batch, torch.Generator().manual_seed(0))
assert all(torch.isfinite(v) for v in metrics.values()), metrics
print("ok")
"""


def test_the_port_no_longer_imports_scipy():
    """Every module imports, and a training step with its matchings runs,
    with scipy unimportable. (The route planner, a verbatim copy of the JAX
    package's, keeps the reference agent's lazy ``scipy.optimize.fsolve``
    for the town's GNSS origin.)"""
    res = subprocess.run([sys.executable, "-c", _NO_SCIPY], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    sources = [p for p in (ROOT / "hipad_torch").rglob("*.py")
               if "scipy" in p.read_text() and p.name != "planner.py"]
    assert not sources, sources
