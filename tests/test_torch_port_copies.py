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
    """Equal key for key, but for the ego trajectories: the original draws
    them unit after unit in the order of a set of strings (this process's
    hash seed), the copy in sorted order, so the copy's i-th unit in sorted
    order holds the original's i-th draw, bit for bit."""
    cfg = tcfg.tiny()
    t, j = tsyn.make_batch(cfg, 2, seed=seed), jsyn.make_batch(cfg, 2, seed=seed)
    assert t.keys() == j.keys()
    units = {u[1] for u in cfg.plan_anchor_types} | {cfg.plan_speed_refer[1]}
    drawn = {}  # original key -> the copy's key holding the same draw
    for ours, theirs in zip(sorted(units), list(units)):  # list(): the original's order
        for part in ("trajs", "masks"):
            key = lambda u: f"{'gt_ego_spat' if u.endswith('m') else 'gt_ego_fut'}_{part}_{u}"
            drawn[key(theirs)] = key(ours)
    for k in j:
        _same(t[drawn.get(k, k)], j[k], f"make_batch[{k}]")


@pytest.mark.parametrize("path", ["data/pipelines.py", "agent/calib.py", "agent/pid.py",
                                  "agent/planner.py", "agent/replay.py", "data/sampler.py",
                                  "eval/__init__.py", "eval/detection.py", "eval/map.py",
                                  "eval/motion.py", "eval/planning.py", "eval/report.py",
                                  "utils/viz.py"])
def test_verbatim_copies_equal_the_originals(path):
    """Copied file for file: the training pipeline's geometry, the rig
    calibration, the PID controller, the route planner and the fake
    simulator (whose relative imports reach the port's own agent), the
    training loader's sequence sampler, the numpy metrics and report
    tables of the open-loop eval, and the composite dumps' rendering (whose
    relative import reaches the port's own ``box3d_to_corners``)."""
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


def _tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["conv_w", "linear_w", "_bn", "_set", "convert_backbone",
                                  "_lin", "_ln", "_mlpln", "_mha", "_conv_bn_encoder",
                                  "_refine_reg_cls", "convert_decoder", "convert", "_flatten"])
def test_converter_rules_are_the_tools(name):
    """``hipad_torch/tools/convert_weights.py`` keeps ``tools/convert_weights.py``'s
    numpy rules verbatim (its own ``merge_into`` and ``main`` need no JAX)."""
    from hipad_torch.tools import convert_weights

    tool = _tool("convert_weights")
    assert inspect.getsource(getattr(convert_weights, name)) == \
        inspect.getsource(getattr(tool, name))
    for const in ("HEAD", "SINGLE_LAYER", "TEMPORAL_LAYER", "STAGE2_OPS", "GNN_GROUPS"):
        assert getattr(convert_weights, const) == getattr(tool, const), const


@pytest.mark.parametrize("name", ["kmeans", "det_anchors", "map_anchors", "motion_anchors",
                                  "plan_spatial_anchors", "resample_spacing", "main"])
def test_kmeans_tool_is_a_copy(name):
    """``hipad_torch/tools/kmeans.py`` is ``tools/kmeans.py`` function for
    function, but for the two imports of the JAX package's data modules,
    which reach the port's."""
    from hipad_torch.tools import kmeans

    src = inspect.getsource(getattr(_tool("kmeans"), name)).replace("from hipad_tpu.data.",
                                                                     "from ..data.")
    assert inspect.getsource(getattr(kmeans, name)) == src


def test_error_sweep_numpy_halves_are_the_tools():
    """``hipad_torch/tools/serving_error_sweep.py``: ``_print_retention`` is
    ``tools/serving_error_sweep.py``'s function, and ``deltas`` the body of
    that tool's nested ``deltas`` (which reads ``exact`` and ``exact_cfg``
    from its closure; the port passes them), ``sig`` its ``sig``."""
    from hipad_torch.tools import serving_error_sweep

    tool = {n.name: n for n in ast.walk(ast.parse((ROOT / "tools" /
                                                   "serving_error_sweep.py").read_text()))
            if isinstance(n, ast.FunctionDef)}
    port = {n.name: n for n in ast.parse(inspect.getsource(serving_error_sweep)).body
            if isinstance(n, ast.FunctionDef)}
    assert ast.dump(port["_print_retention"]) == ast.dump(tool["_print_retention"])
    assert [ast.dump(s) for s in port["deltas"].body[1:]] == \
        [ast.dump(s) for s in tool["deltas"].body]
    assert ast.dump(port["sig"].body[0]) == ast.dump(tool["sig"].body[0])
