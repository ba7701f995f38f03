"""The port's own copies of the JAX package's configuration, synthetic data
and numpy-only agent, data and eval modules held to the originals bit for
bit. The port itself imports nothing of ``hipad_tpu``."""

import ast
import dataclasses
import inspect
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
                                  "agent/planner.py", "agent/replay.py", "data/sampler.py",
                                  "eval/__init__.py", "eval/detection.py", "eval/map.py",
                                  "eval/motion.py", "eval/planning.py", "eval/report.py"])
def test_verbatim_copies_equal_the_originals(path):
    """Copied file for file: the training pipeline's geometry, the rig
    calibration, the PID controller, the route planner and the fake
    simulator (whose relative imports reach the port's own agent), the
    training loader's sequence sampler, and the numpy metrics and report
    tables of the open-loop eval."""
    assert (ROOT / "hipad_torch" / path).read_bytes() == (ROOT / "hipad_tpu" / path).read_bytes()


def _without(tree: ast.Module, cls: str, method: str) -> str:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            node.body = [n for n in node.body
                         if not (isinstance(n, ast.FunctionDef) and n.name == method)]
    return ast.dump(tree)


def test_dataset_copy_departs_only_in_load_images():
    """``data/bench2drive.py`` is the original but for ``load_images``, which
    raises where the original loads zeros for a file that exists while PIL
    is missing (``tests/test_torch_eval_data.py`` holds the frames)."""
    port, orig = ((ROOT / pkg / "data" / "bench2drive.py").read_text()
                  for pkg in ("hipad_torch", "hipad_tpu"))
    assert port != orig
    assert _without(ast.parse(port), "Bench2DriveDataset", "load_images") == \
        _without(ast.parse(orig), "Bench2DriveDataset", "load_images")


@pytest.mark.parametrize("name", ["sequence_spans", "rank_spans", "_assign_slots", "_Collector",
                                  "_summarize"])
def test_eval_runner_numpy_half_is_a_copy(name):
    """The runner's scheduling, per-frame records and summary are the JAX
    runner's source; only the model half is the port's."""
    from hipad_torch.eval import runner as trun
    from hipad_tpu.eval import runner as jrun

    assert inspect.getsource(getattr(trun, name)) == inspect.getsource(getattr(jrun, name))
