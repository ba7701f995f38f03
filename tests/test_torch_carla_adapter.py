"""The port's CARLA leaderboard agent (``hipad_torch/agent/carla_adapter.py``)
against the JAX package's on the CPU, through the leaderboard's own entry
points and ``input_data`` format (BGRA camera tuples, the 7-float IMU, GNSS
lat/lon, the speedometer dict) without ``carla`` or ``leaderboard``: the
entry point and sensor rig, the observation each adapter hands its core,
three ticks of both agents on the same weights, the conf string, a
checkpoint dir, and the port's launcher ``hipad_torch/tools/run_closed_loop.sh``
against a mock CARLA and leaderboard evaluator. Every test builds its own
agent."""

import json
import os
import pathlib
import subprocess
import sys
import xml.etree.ElementTree as ET

import jax
import numpy as np
import pytest
import torch

from hipad_torch.agent import carla_adapter as tad
from hipad_torch.agent.calib import CAMERAS
from hipad_torch.configs.model import tiny
from hipad_torch.models.detector import HiPAD
from hipad_torch.train.checkpoint import save_checkpoint
from hipad_torch.train.optim import AdamW
from hipad_torch.weights import from_jax, init_random
from hipad_tpu.agent import carla_adapter as jad
from test_carla_adapter import LAT_REF, LON_REF, TinyAgent as JaxTinyAgent
from test_carla_adapter import _input_data, _make_route

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
AUG_CONF = {
    "resize_lim": (0.4, 0.4), "final_dim": (64, 128), "bot_pct_lim": (0.0, 0.0),
    "rot_lim": (0.0, 0.0), "H": 90, "W": 160, "rand_flip": False, "rot3d_range": (0.0, 0.0),
}
# the controls of two fp32 forwards of the same weights, as
# tests/test_torch_serve_agent.py holds them
CONTROL_ATOL = 1e-4
TICKS = 3


class TinyAgent(tad.HiPADTorchAgent):
    """The port's adapter at the test scale, through its hooks, on the CPU."""

    weights = None

    def _make_config(self, name):
        assert name == "tiny"  # the conf string's option reached the hook
        return tiny(num_cams=6, input_size=(64, 128))

    def _agent_core_kwargs(self):
        return dict(dtype=torch.float32, jpeg_quality=None, aug_conf=AUG_CONF, n_banks=2,
                    device="cpu")

    def _initial_weights(self, cfg):
        return super()._initial_weights(cfg) if self.weights is None else self.weights


def _ready(agent):
    """What the leaderboard sets before the first ``run_step``."""
    agent._global_plan_world_coord, agent._global_plan = _make_route()
    return agent


def _setup(cls, conf, tmp_path, **attrs):
    agent = cls("carla_host_port_junk")  # the leaderboard passes its own arguments
    for k, v in attrs.items():
        setattr(agent, k, v)
    saved = os.environ.get("SAVE_PATH")
    os.environ["SAVE_PATH"] = str(tmp_path)
    try:
        agent.setup(conf)
    finally:
        if saved is None:
            del os.environ["SAVE_PATH"]
        else:
            os.environ["SAVE_PATH"] = saved
    return _ready(agent)


def test_entry_point_and_sensor_rig():
    assert tad.get_entry_point() == "HiPADTorchAgent"
    assert tad._sensor_specs() == jad._sensor_specs()
    cams = [s["id"] for s in tad._sensor_specs() if s["type"] == "sensor.camera.rgb"]
    assert set(cams) == set(CAMERAS)


class _StubCore:
    """Records the observation an adapter hands its core."""

    def __init__(self):
        self.seen, self.metric_info = [], {}

    def run_step(self, obs):
        self.seen.append(obs)
        self.metric_info[len(self.seen) - 1] = {"tick": len(self.seen)}
        return {"steer": 0.0, "throttle": 0.0, "brake": 0.0, "metadata": {}}


def _bare(cls, tmp_path):
    """An adapter with a stub core, without ``setup``'s model."""
    agent = cls()
    agent.core, agent._route_planner = _StubCore(), None
    agent.save_path = tmp_path
    agent.lat_ref, agent.lon_ref = 42.0, 2.0
    return _ready(agent)


def test_both_adapters_hand_their_cores_the_same_obs(tmp_path):
    port, ref = _bare(tad.HiPADTorchAgent, tmp_path), _bare(jad.HiPADTpuAgent, tmp_path)
    rng = np.random.RandomState(0)
    for t, x in enumerate((1.0, 4.0, 10.0)):
        data = _input_data((x, 2.0), rng)
        assert port.run_step(data, 0.05 * t) == ref.run_step(data, 0.05 * t)
        assert port.lat_ref == ref.lat_ref and port.lon_ref == ref.lon_ref
        got, want = port.core.seen[-1], ref.core.seen[-1]
        assert got.keys() == want.keys()
        for cam in CAMERAS:
            np.testing.assert_array_equal(got["images"][cam], want["images"][cam])
            np.testing.assert_array_equal(got["images"][cam], data[cam][1][..., 2::-1])
        for k in ("pos", "speed", "compass", "acceleration", "angular_velocity", "target_xy",
                  "command"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.lat_ref == pytest.approx(LAT_REF, abs=1e-3)
    assert port.lon_ref == pytest.approx(LON_REF, abs=1e-3)
    assert json.loads((tmp_path / "metric_info.json").read_text())["2"] == {"tick": 3}


def test_three_ticks_match_the_jax_agent(tmp_path):
    """The JAX adapter's seeded weights handed to the port's through the
    initial-weights hook: the same controls over three ticks (two banks in
    round robin, so the third tick reuses the first tick's bank), and the
    leaderboard's artifacts."""
    ref = _setup(JaxTinyAgent, "+jax_run+config=tiny", tmp_path)
    variables = jax.tree_util.tree_map(np.asarray, ref.core.variables)
    port = _setup(TinyAgent, "+torch_run+config=tiny", tmp_path, weights=from_jax(variables))
    # where the JAX package's native library is not built it resamples with
    # PIL: its core takes the port's inputs (test_torch_serve_agent.py holds
    # the two preprocessings against each other)
    built = []
    build = port.core._build_inputs
    port.core._build_inputs = lambda obs: built.append(build(obs)) or built[-1]
    ref.core._build_inputs = lambda obs: built[-1]
    rng = np.random.RandomState(0)
    for t, x in enumerate((1.0, 2.0, 3.5)):
        data = _input_data((x, 2.0), rng)
        got, want = port.run_step(data, 0.05 * t), ref.run_step(data, 0.05 * t)
        for k in ("steer", "throttle", "brake"):
            assert abs(got[k] - want[k]) <= CONTROL_ATOL, (t, k, got[k], want[k])
        assert -1.0 <= got["steer"] <= 1.0 and 0.0 <= got["throttle"] <= 0.75
        assert 0.0 <= got["brake"] <= 1.0
    dumped = json.loads((tmp_path / "torch_run" / "metric_info.json").read_text())
    assert sorted(dumped) == ["0", "1", "2"]
    assert port.save_path.name == "torch_run"


def test_conf_string_refuses_unknown_keys(tmp_path):
    with pytest.raises(ValueError, match="unknown agent conf option"):
        _setup(TinyAgent, "+run+confg=tiny", tmp_path)


def test_checkpoint_dir_loads_over_the_initial_weights(tmp_path):
    """``<ckpt_dir>+<save_name>``: a work dir of the port's checkpoints
    loads into the agent's model; the save name defaults to hipad_torch."""
    cfg = tiny(num_cams=6, input_size=(64, 128))
    model = init_random(HiPAD(cfg, device="cpu"), 5)
    save_checkpoint(str(tmp_path / "ckpt"), 3, model, AdamW(model.named_parameters()))
    agent = _setup(TinyAgent, f"{tmp_path / 'ckpt'}+config=tiny", tmp_path)
    assert agent.save_name == "hipad_torch"
    for k, v in model.state_dict().items():
        assert torch.equal(agent.core.model.state_dict()[k], v), k


_MOCK_EVALUATOR = '''\
"""Mock leaderboard_evaluator: records the worker's command line and
environment and writes a leaderboard checkpoint for its routes."""
import json, os, sys
import xml.etree.ElementTree as ET

args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
records = []
for r in ET.parse(args["--routes"]).getroot().findall("route"):
    rid = int(r.get("id"))
    records.append({
        "route_id": f"RouteScenario_{rid}", "town_name": r.get("town"),
        "scenario_name": "MergerIntoSlowTraffic",
        "status": "Failed" if rid == 3 else "Completed",
        "scores": {"score_composed": 100.0 - 10.0 * rid},
        "infractions": {"collisions_vehicle": ["hit"] if rid == 3 else [],
                        "min_speed_infractions": ["slow"] if rid == 1 else []},
    })
out = {"_checkpoint": {"global_record": {"index": len(records)}, "records": records},
       "port": args["--port"], "agent": args["--agent"],
       "agent_config": args["--agent-config"], "resume": args["--resume"],
       "gpu": os.environ.get("CUDA_VISIBLE_DEVICES"), "save_path": os.environ["SAVE_PATH"]}
with open(args["--checkpoint"], "w") as f:
    json.dump(out, f)
'''


def test_launcher_against_a_mock_harness(tmp_path):
    """``hipad_torch/tools/run_closed_loop.sh`` end to end against a mock
    CARLA binary and leaderboard evaluator: three workers on two GPUs, each
    with its own RPC port, GPU (i % GPU_NUM), save name and logs, the port's
    adapter as ``--agent``, and ``tools/route_stats.py``'s merge."""
    carla_root = tmp_path / "carla"
    carla_root.mkdir()
    (carla_root / "CarlaUE4.sh").write_text("#!/bin/bash\necho carla up\nexec sleep 120\n")
    (carla_root / "CarlaUE4.sh").chmod(0o755)
    lb = tmp_path / "lb" / "leaderboard"
    lb.mkdir(parents=True)
    (lb / "leaderboard_evaluator.py").write_text(_MOCK_EVALUATOR)
    root = ET.Element("routes")
    for i in range(5):
        ET.SubElement(root, "route", id=str(i), town=f"Town{i % 2 + 1:02d}")
    src = tmp_path / "routes.xml"
    ET.ElementTree(root).write(src)
    splits = tmp_path / "splits"
    subprocess.run([sys.executable, str(ROOT / "tools" / "split_routes.py"), "--routes",
                    str(src), "--num", "3", "--out-dir", str(splits)], check=True)
    out = tmp_path / "out"
    env = dict(os.environ, TASK_NUM="3", GPU_NUM="2", CARLA_BOOT_WAIT="1",
               CARLA_ROOT=str(carla_root), LEADERBOARD_ROOT=str(tmp_path / "lb"),
               ROUTES_DIR=str(splits), CKPT="work_dirs/dummy")
    res = subprocess.run(["bash", str(ROOT / "hipad_torch" / "tools" / "run_closed_loop.sh"),
                          str(out)], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    merged = json.loads((out / "merged.json").read_text())
    assert len(merged["routes"]) == 5
    assert merged["success_rate"] == pytest.approx(80.0)
    shards = [json.loads((out / f"route_{i}.json").read_text()) for i in range(3)]
    assert [s["port"] for s in shards] == ["20082", "20232", "20382"]
    assert [s["gpu"] for s in shards] == ["0", "1", "0"]
    assert [s["agent_config"] for s in shards] == [f"work_dirs/dummy+hipad_torch_{i}"
                                                   for i in range(3)]
    assert [pathlib.Path(s["save_path"]).name for s in shards] == ["agent_0", "agent_1",
                                                                   "agent_2"]
    assert all(s["resume"] == "True" for s in shards)
    agent = pathlib.Path(shards[0]["agent"])
    assert agent.resolve() == (ROOT / "hipad_torch" / "agent" / "carla_adapter.py").resolve()
    for i in range(3):
        assert (out / f"carla_{i}.log").exists() and (out / f"eval_{i}.log").exists()
