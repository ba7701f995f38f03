"""The training CLI ``python -m hipad_torch.tools.train`` on the CPU at
``tiny()``: three synthetic steps with gradient accumulation (A=2) in one
run, then the same three as two steps plus ``--resume``; the resumed run
logs the unbroken run's numbers bit for bit (the CPU repeats the same
operations in the same order, so the tolerance is zero). The log has the
JAX CLI's keys (``tools/train.py``: every loss, ``total_loss``,
``grad_norm``, ``iter``, ``time``, ``ips``); the options that wait for a
later port are refused by name. (That ``--device cuda``, the default,
raises without a card is held by ``test_torch_port_hygiene.py``.)"""

import json
import os

import pytest
import torch

from hipad_torch.tools import train

BASE = ["--device", "cpu", "--tiny", "--accum-steps", "2", "--batch-size", "1",
        "--log-interval", "1", "--ckpt-interval", "2"]
KEYS = {"det_loss_cls", "det_loss_box", "det_loss_cns", "det_loss_yns", "map_loss_cls",
        "map_loss_line", "ego_loss_status", "motion_loss_cls", "motion_loss_reg",
        "plan_loss_temp_cls", "plan_loss_temp_reg", "plan_loss_spat_cls", "plan_loss_spat_reg",
        "plan_loss_speed_cls", "plan_loss_speed_reg", "total_loss", "grad_norm", "iter", "time",
        "ips"}

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _log(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_continues_the_unbroken_run(tmp_path):
    whole, broken = str(tmp_path / "whole"), str(tmp_path / "broken")
    ref = train.main(BASE + ["--synthetic", "3", "--work-dir", whole])
    assert ref["start"] == 0 and len(ref["metrics"]) == 3
    first = train.main(BASE + ["--synthetic", "2", "--work-dir", broken])
    assert len(first["metrics"]) == 2
    rest = train.main(BASE + ["--synthetic", "3", "--work-dir", broken, "--resume"])
    assert rest["start"] == 2 and len(rest["metrics"]) == 1
    assert first["metrics"] + rest["metrics"] == ref["metrics"]

    logs = _log(whole)
    assert [m["iter"] for m in logs] == [1, 2, 3]
    for m in logs:
        assert set(m) == KEYS, set(m) ^ KEYS
    resumed = _log(broken)
    assert [m["iter"] for m in resumed] == [1, 2, 3]
    for a, b in zip(resumed, logs):
        assert {k: v for k, v in a.items() if k not in ("time", "ips")} == \
            {k: v for k, v in b.items() if k not in ("time", "ips")}
    assert sorted(os.listdir(whole)) == ["3", "train_log.jsonl"]  # keep=1


@pytest.mark.parametrize("option, item", [
    ("--ann-file", "13a"), ("--eval-interval", "13b"), ("--synthetic-pool", "--synthetic"),
])
def test_options_that_wait_are_refused_by_name(option, item, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(["--device", "cpu", "--synthetic", "1", option, "4"])
    err = capsys.readouterr().err
    assert option in err and item in err, err


def test_training_needs_synthetic_batches(capsys):
    with pytest.raises(SystemExit):
        train.parse_args(["--device", "cpu"])
    assert "13a" in capsys.readouterr().err
