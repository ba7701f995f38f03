"""The port's serving tools on the CPU at ``tiny()``: the error sweep
(``hipad_torch/tools/serving_error_sweep.py``: its rows those of
``tools/serving_error_sweep.py``, their deltas against a numpy
recomputation, the exact run against itself at 0, the retention printout
the tool's) and the closed-loop serving bench over 3 ticks, writing under
``tmp_path``. (The numpy halves are held to the tool's source in
``test_torch_port_copies.py``.)"""

import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from hipad_torch.configs.model import SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER, tiny
from hipad_torch.models.decoder import SparseOneDecoder
from hipad_torch.tools import closed_loop_serving_bench as bench
from hipad_torch.tools import serving_error_sweep as sweep
from hipad_torch.weights import init_random

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASE = dict(num_cams=6, operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2)
_R = dict(sampler_cam_k=2, sampler_cam_renorm=True)
# the shipped rows' knobs at tiny()'s counts (3 refine layers, 12 det
# anchors, 3 plan modes)
TINY_ROWS = [
    ("cam_k=3 (exact-rig)", dict(sampler_cam_k=3, sampler_cam_renorm=False,
                                 sampler_point_frac=1.0)),
    ("cam_k=2+renorm, frac=0.5", dict(_R, sampler_point_frac=0.5)),
    ("cam_k=2+renorm, level_k=1", dict(_R, sampler_point_frac=1.0, sampler_level_k=1)),
    ("topk_mode", dict(_R, sampler_point_frac=0.5, with_topk_mode=True, topk_mode_list=(3, 2, 2),
                       num_temp_plan_mode=2)),
    ("topk_det", dict(_R, sampler_point_frac=0.5, with_topk_det=True, topk_det_list=(12, 6, 6))),
]


def _jax_tool():
    return ast.parse((ROOT / "tools" / "serving_error_sweep.py").read_text())


def test_rows_are_the_tools():
    """The same rows, names and knobs, as the tool builds in its ``main``
    (its statements from ``sweeps = [...]`` up to the ``--only`` filter,
    run here)."""
    main = next(n for n in _jax_tool().body if isinstance(n, ast.FunctionDef) and n.name == "main")
    first = next(i for i, n in enumerate(main.body) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "sweeps")
    last = next(i for i, n in enumerate(main.body) if isinstance(n, ast.If) and i > first)
    scope = {}
    exec(compile(ast.Module(body=main.body[first:last], type_ignores=[]), "sweeps", "exec"),
         scope)
    assert [(n, dict(k)) for n, k in sweep.ROWS] == scope["sweeps"]


def make_cfg(**knobs):
    return tiny(**BASE, **knobs)


@pytest.fixture(scope="module")
def tiny_sweep():
    exact_cfg = make_cfg(**sweep.exact_knobs(make_cfg()))
    frames, metas = sweep.episode_inputs(exact_cfg, 11, 23, use_full=False)
    sd = init_random(SparseOneDecoder(exact_cfg), 0).state_dict()
    run = sweep.make_runner(sd, frames, metas, use_full=False, device="cpu")
    return exact_cfg, run, sweep.sweep(run, make_cfg, TINY_ROWS, exact_cfg)


def _recompute(exact, approx, cfg):
    """The plan and map columns of frame 2, recomputed."""
    e, a = exact[1], approx[1]
    plan = np.mean(np.sqrt(((e["traj"] - a["traj"]) ** 2).sum(-1)))
    s = 1 / (1 + np.exp(-e["map_cls"][0].astype(np.float64)))
    top = np.argsort(-s.max(-1))[:20]
    ep = e["map_pts"][0].reshape(len(s), -1, 2)[top]
    ap = a["map_pts"][0].reshape(len(s), -1, 2)[top]
    flips = (e["plan_cls"].reshape(cfg.plan_anchor_group, -1).argmax(-1)
             != a["plan_cls"].reshape(cfg.plan_anchor_group, -1).argmax(-1)).sum()
    return plan, np.mean(np.sqrt(((ep - ap) ** 2).sum(-1))), flips


def test_sweep_rows_at_tiny(tiny_sweep):
    exact_cfg, run, rows = tiny_sweep
    assert [r["config"] for r in rows] == [n for n, _ in TINY_ROWS]
    exact, _ = run(exact_cfg)
    zero = sweep.deltas(exact, exact, exact_cfg)
    assert set(zero.values()) == {0}
    for (name, knobs), row in zip(TINY_ROWS, rows):
        vals = [v for k, v in row.items() if k not in ("config", "launches")]
        assert len(vals) == 10 and np.isfinite(vals).all(), name
        assert row["launches"] == {}  # the CPU runs the plain versions
        approx, _ = run(make_cfg(**knobs))
        plan, mpt, flips = _recompute(exact, approx, exact_cfg)
        assert row["f2_plan_l2"] == pytest.approx(plan, rel=1e-6, abs=1e-9), name
        assert row["f2_map_pt_l2"] == pytest.approx(mpt, rel=1e-6, abs=1e-9), name
        assert row["f2_mode_flips"] == flips, name
    assert rows[1]["f2_det_center_l2"] > 0  # an approximation moves the boxes


def test_retention_prints_the_tools_numbers(capsys):
    """``--mode-correlation`` on stage-2-shaped score stacks (its cuts are
    the shipped schedule's: 12 modes, 450 det slots): the tool's output."""
    import sys

    from hipad_torch.configs.model import stage2

    sys.path.insert(0, str(ROOT / "tools"))
    import serving_error_sweep as jsweep

    rng = np.random.default_rng(0)
    frames = [{"plan_cls_stack": rng.normal(size=(6, 1, 1, 480)).astype(np.float32),
               "det_cls_stack": rng.normal(size=(6, 1, 900, 10)).astype(np.float32)}
              for _ in range(2)]
    cfg = stage2()
    sweep._print_retention(cfg, frames)
    got = capsys.readouterr().out
    jsweep._print_retention(cfg, frames)
    assert got == capsys.readouterr().out
    assert len(json.loads(got)["f2_plan_top12_retention_by_layer"]) == 6


def test_serving_bench_three_ticks(tmp_path):
    out = tmp_path / "ticks.jsonl"
    summary = bench.main(["--ticks", "3", "--config", "tiny", "--set", "num_cams=6",
                          "--set", "input_size=(352, 640)", "--device", "cpu",
                          "--out", str(out)])
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert [l["tick"] for l in lines] == [0, 1, 2]
    assert set(lines[0]) >= {"latency_ms", "host_preproc", "upload_infer", "steer", "throttle",
                             "brake", "command", "route_len"}
    assert summary["ticks"] == 3 and summary["controls_sane"] and summary["native_preproc"]
    assert summary["warm_ticks"] == 0 and summary["tick_ms_median"] is None
    assert summary["device"] == "cpu"
    assert str(bench.DEFAULT_OUT).startswith(str(ROOT / "work_dirs"))
