"""The port's own copies of the JAX package's configuration, synthetic data
and numpy-only agent and pipeline modules held to the originals bit for bit.
The port itself imports nothing of ``hipad_tpu``."""

import dataclasses
import pathlib

import numpy as np
import pytest

from hipad_tpu.configs import model as jcfg
from hipad_tpu.data import synthetic as jsyn
from hipad_torch.configs import model as tcfg
from hipad_torch.data import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    else:
        assert a == b, (what, a, b)


@pytest.mark.parametrize("name", ["tiny", "stage2", "stage1", "stage2_serving",
                                  "stage2_serving_topk", "stage2_serving_det",
                                  "stage2_serving_prune", "stage2_r101_2x"])
def test_config_copy_equals_the_original(name):
    """Every field, the anchor arrays included, and the derived properties."""
    t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    _same(t, j, name)
    for prop in ("speed_areas", "ego_anchor_init", "query_counts", "temp_query_counts"):
        if hasattr(j, prop):
            _same(getattr(t, prop), getattr(j, prop), f"{name}.{prop}")


def test_config_module_constants():
    for name in ("SINGLE_FRAME_LAYER", "TEMPORAL_FRAME_LAYER", "DET_CLASS_NAMES",
                 "MAP_CLASS_NAMES", "DET_KPS", "EGO_KPS", "GROUND_HEIGHT"):
        _same(getattr(tcfg, name), getattr(jcfg, name), name)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_copy_equals_the_original(seed):
    cfg = tcfg.tiny()
    t, j = tsyn.make_batch(cfg, 2, seed=seed), jsyn.make_batch(cfg, 2, seed=seed)
    assert t.keys() == j.keys()
    for k in j:
        _same(t[k], j[k], f"make_batch[{k}]")


@pytest.mark.parametrize("path", ["data/pipelines.py", "agent/calib.py", "agent/pid.py",
                                  "agent/planner.py", "agent/replay.py"])
def test_verbatim_copies_equal_the_originals(path):
    """Copied file for file: the training pipeline's geometry, the rig
    calibration, the PID controller, the route planner and the fake
    simulator (whose relative imports reach the port's own agent)."""
    assert (ROOT / "hipad_torch" / path).read_bytes() == (ROOT / "hipad_tpu" / path).read_bytes()
