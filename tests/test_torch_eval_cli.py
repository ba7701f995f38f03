"""The eval CLI ``python -m hipad_torch.tools.test`` and the training CLI on
a dataset (``--ann-file``, ``--eval-interval``) on the CPU at the tiny
config, over a split of ``tools/make_synthetic_val.py`` (no camera files:
every camera loads as zeros, and the CLI says so). That both CLIs raise
without a card unless told ``--device cpu`` is held by
``test_torch_port_hygiene.py``."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from hipad_torch.eval.runner import run_openloop_eval
from hipad_torch.models.detector import HiPAD
from hipad_torch.tools import test as eval_cli
from hipad_torch.tools import train
from hipad_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _split(out_dir, frames_per_route):
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synthetic_val.py"),
                    "--routes", "2", "--frames-per-route", str(frames_per_route),
                    "--out-dir", str(out_dir)], check=True, capture_output=True)
    return str(out_dir / "b2d_infos_val.pkl"), str(out_dir / "b2d_map_infos.pkl")


@pytest.fixture(scope="module")
def small_split(tmp_path_factory):
    return _split(tmp_path_factory.mktemp("synth_val_12"), 12)


@pytest.mark.parametrize("slots", ["1", "2"])
def test_eval_cli_prints_the_summary_of_the_frames_it_evaluated(small_split, slots, tmp_path,
                                                                 capsys):
    """24 frames, ``--max-frames 100``: ``perf.frames`` and ``fps_wall``
    count the 24 evaluated, not 100; the camera and motion-match lines come
    before the tables; ``--out`` holds the printed summary."""
    ann, mp = small_split
    out = tmp_path / "res.json"
    res = eval_cli.main(["--device", "cpu", "--tiny", "--ann-file", ann, "--map-file", mp,
                         "--eval-det", "--eval-map", "--eval-motion", "--max-frames", "100",
                         "--batch-slots", slots, "--num-workers", slots, "--out", str(out),
                         "--gather-dir", str(tmp_path / "gather")])
    text = capsys.readouterr().out
    printed = json.loads(text[text.rindex("\n{\n") + 1:])
    perf = printed.pop("perf")
    assert perf["frames"] == 24 == len(res["records"]["frames"])
    assert perf["fps_wall"] == pytest.approx(24 / perf["wall_s"], rel=1e-2)
    assert 0 < perf["load_s"] < perf["wall_s"]
    assert set(printed) == {"planning", "detection", "map", "motion"}
    assert printed["motion"]["car_matches"] == res["summary"]["motion"]["car_matches"]
    assert res["cameras"] == {"found": 0, "absent": 24 * 6}
    assert "0 of 144 files of the 24 frames found; 144 absent, loaded as zeros" in text
    assert text.index("motion: matched agents") < text.index("class names")
    with open(out) as f:
        saved = json.load(f)
    assert saved["perf"] == perf and saved["summary"]["map"] == printed["map"]


def test_train_cli_on_a_dataset_evaluates_every_interval(tmp_path, capsys):
    """Two optimizer steps on the loader with an eval after each: both
    steps logged, two summaries with planning metrics, printed. (80-frame
    routes: planning scores frames with 1 s of past and 3 s of future in
    their route, frames 10-49; the first 10 eval frames hold eight.)"""
    ann, mp = _split(tmp_path / "synth_val_80", 80)
    res = train.main(["--device", "cpu", "--tiny", "--ann-file", ann, "--map-file", mp,
                      "--val-ann-file", ann, "--eval-interval", "1", "--eval-frames", "10",
                      "--max-iters", "2", "--batch-size", "2", "--log-interval", "1",
                      "--work-dir", str(tmp_path / "work")])
    assert res["iters"] == 2 and len(res["metrics"]) == 2
    assert all(torch.isfinite(torch.tensor(m["total_loss"])) for m in res["metrics"])
    assert "depth_loss" not in res["metrics"][0]  # no LiDAR files: skipped, as in JAX
    assert [e["eval_at"] for e in res["evals"]] == [1, 2]
    assert all("plan_L2_1s" in e["planning"] for e in res["evals"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [x["eval_at"] for x in lines if "eval_at" in x] == [1, 2]
    assert [x["iter"] for x in lines if "iter" in x] == [1, 2]
    assert sorted(os.listdir(tmp_path / "work")) == ["2", "train_log.jsonl"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_cli_evaluates_across_two_ranks(tmp_path):
    """Two gloo processes, one step and ``--eval-interval 1`` over 16 frames
    (two sequences): each rank evaluates its sequence, rank 0 merges the
    records from the work dir and prints the summary, rank 1 prints none.
    The summary is one process's eval of the checkpoint rank 0 wrote at that
    step: the same forwards, so ``tests/test_eval_runner.py``'s rel 1e-6,
    abs 1e-8, plus the 5e-5 of the log's rounding to 4 decimals."""
    ann, mp = _split(tmp_path / "synth_val_80", 80)
    work = str(tmp_path / "work")
    cmd = [sys.executable, "-m", "hipad_torch.tools.train", "--device", "cpu", "--tiny",
           "--ann-file", ann, "--map-file", mp, "--val-ann-file", ann, "--eval-interval", "1",
           "--eval-frames", "16", "--max-iters", "1", "--batch-size", "2", "--log-interval",
           "1", "--dist-backend", "gloo", "--work-dir", work]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    evals = [[json.loads(x) for x in out.splitlines() if x.startswith('{"eval_at"')]
             for out, _ in outs]
    assert len(evals[0]) == 1 and evals[1] == []
    assert sorted(os.listdir(work)) == ["1", "train_log.jsonl"]  # the gather dir is gone

    cfg = eval_cli.config(2, True)
    model = HiPAD(cfg, device="cpu")
    assert not checkpoint.load_params_only(work, model)
    ref = run_openloop_eval(model, eval_cli.open_dataset(cfg, ann, mp, "data/bench2drive",
                                                         test_mode=True), max_frames=16)
    got = evals[0][0]
    flat = {f"{k}/{m}": float(x) for k, d in ref.items() for m, x in d.items()}
    assert set(got) - {"eval_at"} == set(flat)
    for k, v in flat.items():
        assert abs(got[k] - v) <= 5e-5 + 1e-6 * abs(v) + 1e-8, (k, got[k], v)
