"""What the port must never do: import JAX or anything of the JAX package
``hipad_tpu`` (on any path: forward, training, serving, the CLIs, the
open-loop eval, the model options, the CARLA agent and its launcher, the
serving tools, the converter and k-means), or fall back to the CPU when it was
asked to run on a card, or let a native call return None where it should
raise; and what its layers keep apart: no model module imports the losses,
and the decoder runs every option but those it refuses by name."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX_FORWARD = r"""
import sys
sys.modules["jax"] = None   # any import of jax or flax now raises ImportError
sys.modules["flax"] = None
import pkgutil, importlib, torch
import hipad_torch
for m in pkgutil.walk_packages(hipad_torch.__path__, "hipad_torch."):
    importlib.import_module(m.name)
import chip_smoke  # defines its phases only; runs nothing on import
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from hipad_torch.weights import init_random
cfg = tiny()
model = init_random(HiPAD(cfg, device="cpu"), 0)
batch = synthetic.make_batch(cfg, 1)
images, metas = batch_to_torch(batch, "cpu")
with torch.no_grad():
    out, banks = model(images, metas)
    out, banks = model(images, metas, banks)
assert torch.isfinite(out["plan"]["final_waypoints"]).all()
step = make_train_step(cfg, model, AdamW(model.named_parameters()))
banks, metrics = step(banks, {k: torch.as_tensor(v) for k, v in batch.items()},
                      torch.Generator().manual_seed(0))
assert all(torch.isfinite(v) for v in metrics.values()), metrics
# the serving path: pruning knobs, post-processing, the agent, the probes
from hipad_torch import postprocess
from hipad_torch.agent.core import AgentCore
from hipad_torch.agent.replay import FakeSim, run_replay
from hipad_torch.tools import probe_gather
from hipad_torch.configs.model import SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER
scfg = tiny(sampler_point_frac=0.5, with_topk_det=True, topk_det_list=(12, 6, 6),
            with_topk_mode=True, topk_mode_list=(3, 2, 2), num_temp_plan_mode=2,
            operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2)
smodel = init_random(HiPAD(scfg, device="cpu"), 0)
with torch.no_grad():
    out, banks = smodel(images, metas)
    out, banks = smodel(images, metas, banks)
    dec = postprocess.post_process_arrays(scfg, out, metas["gt_ego_fut_cmd"])
assert torch.isfinite(dec["plan_speed_5hz"]).all()
# the model options: masks, point expansion, the level top-k, the oracle sampler
for opts in (dict(sampler_level_k=1, with_distance_attn_mask=True, with_velocity_attn_mask=True,
                  with_deform_map_points=True, with_deform_plan_points=True),
             dict(with_concat_map_points=True, with_concat_plan_points=True),
             dict(sampler="reference")):
    with torch.no_grad():
        out, _ = init_random(HiPAD(tiny(**opts), device="cpu"), 0)(images, metas)
    assert torch.isfinite(out["plan"]["final_waypoints"]).all(), opts
acfg = tiny(num_cams=6, input_size=(64, 128))
aug_conf = {"resize_lim": (0.4, 0.4), "final_dim": (64, 128), "bot_pct_lim": (0.0, 0.0),
            "rot_lim": (0.0, 0.0), "H": 90, "W": 160, "rand_flip": False,
            "rot3d_range": (0.0, 0.0)}
agent = AgentCore(acfg, HiPAD(acfg, device="cpu").state_dict(), dtype=torch.float32,
                  aug_conf=aug_conf, n_banks=2, device="cpu")
log = run_replay(agent, max_steps=2, sim=FakeSim(img_hw=(90, 160)))
assert len(log) == 2
assert probe_gather.run("C", device="cpu")[2]
# the closed loop: the leaderboard agent, the serving bench, the tools
from hipad_torch.agent import carla_adapter
from hipad_torch.tools import closed_loop_serving_bench, convert_weights, kmeans
from hipad_torch.tools import serving_error_sweep
from hipad_torch.utils import viz
assert carla_adapter.get_entry_point() == "HiPADTorchAgent"
assert viz.render_frame({}).shape == (512, 512, 3)
assert closed_loop_serving_bench.main(["--ticks", "2", "--config", "tiny", "--set", "num_cams=6",
                                       "--device", "cpu", "--out", "/dev/null"])["ticks"] == 2
# the training entry point and data parallelism (one process, no group)
import tempfile
from hipad_torch.parallel import mesh
from hipad_torch.tools import train
assert mesh.init("gloo", "", 1, 0).group is None
with tempfile.TemporaryDirectory() as work:
    res = train.main(["--device", "cpu", "--tiny", "--synthetic", "1", "--batch-size", "1",
                      "--work-dir", work])
assert len(res["metrics"]) == 1
# the open-loop eval path: the dataset, the runner and the eval CLI
from hipad_torch.data.bench2drive import Bench2DriveDataset
from hipad_torch.eval import runner
from hipad_torch.tools import test as eval_cli
with tempfile.TemporaryDirectory() as split:
    import subprocess
    subprocess.run([sys.executable, "tools/make_synthetic_val.py", "--routes", "1",
                    "--frames-per-route", "6", "--out-dir", split], check=True,
                   capture_output=True)
    res = eval_cli.main(["--device", "cpu", "--tiny", "--ann-file", f"{split}/b2d_infos_val.pkl",
                         "--eval-det", "--eval-motion", "--max-frames", "4"])
assert res["perf"]["frames"] == 4
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                and sys.modules[m] is not None)
assert not loaded, loaded
reached = sorted(m for m in sys.modules if m.split(".")[0] == "hipad_tpu")
assert not reached, reached
print("ok")
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT))


def test_port_imports_and_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX_FORWARD], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|hipad_tpu)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in (ROOT / "hipad_torch").rglob("*.py")
                 if pat.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pat.search((ROOT / "chip_smoke.py").read_text()) else []
    assert not offenders


def test_chip_smoke_fails_without_a_card():
    """On a host without CUDA the smoke exits non-zero and prints no result:
    there is no CPU fallback to report as a chip run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_train_cli_fails_without_a_card():
    """``python -m hipad_torch.tools.train`` trains on the card unless told
    ``--device cpu``: on a host without CUDA it exits non-zero before
    training; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = subprocess.run([sys.executable, "-m", "hipad_torch.tools.train", "--tiny",
                          "--synthetic", "1", "--work-dir", "/nonexistent/never-written"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert "training done" not in res.stdout


def test_eval_cli_fails_without_a_card():
    """``python -m hipad_torch.tools.test`` runs on the card unless told
    ``--device cpu``: without CUDA it exits non-zero before evaluating."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = subprocess.run([sys.executable, "-m", "hipad_torch.tools.test", "--tiny",
                          "--ann-file", "/nonexistent/never-read.pkl"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert '"perf"' not in res.stdout


@pytest.mark.parametrize("tool", ["closed_loop_serving_bench", "serving_error_sweep"])
def test_serving_tools_fail_without_a_card(tool):
    """The serving bench and the error sweep run on the card unless told
    ``--device cpu``: without CUDA they exit non-zero before building a
    model, and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = subprocess.run([sys.executable, "-m", f"hipad_torch.tools.{tool}", "--out",
                          "/nonexistent/never-written"] if tool.startswith("closed") else
                         [sys.executable, "-m", f"hipad_torch.tools.{tool}"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]


def test_carla_agent_runs_on_the_card_by_default():
    """The leaderboard agent's model goes to the card unless a harness asks
    for the CPU; without CUDA its setup raises."""
    from hipad_torch.agent.carla_adapter import HiPADTorchAgent
    from hipad_torch.configs.model import tiny

    class Tiny(HiPADTorchAgent):
        def _make_config(self, name):
            return tiny(num_cams=6, input_size=(64, 128))

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        Tiny().setup("+never_written+config=tiny")


def test_launcher_hands_the_leaderboard_the_ports_agent():
    """``hipad_torch/tools/run_closed_loop.sh`` passes the port's adapter as
    ``--agent`` and names nothing of the JAX package."""
    script = (ROOT / "hipad_torch" / "tools" / "run_closed_loop.sh").read_text()
    agents = re.findall(r'--agent="\$\{REPO_ROOT\}/([^"]+)"', script)
    assert agents == ["hipad_torch/agent/carla_adapter.py"]
    assert (ROOT / agents[0]).is_file()
    assert "hipad_tpu" not in script


def test_native_binding_never_returns_none_in_place_of_raising():
    """The JAX package's binding returns None without its library and its
    callers fall back to numpy; the port's builds the library or raises,
    and every entry point returns its result."""
    from hipad_torch.data import native

    src = (ROOT / "hipad_torch" / "data" / "native.py").read_text()
    assert not re.search(r"return None|Optional\[|def available", src)
    for name in ("preprocess_cameras", "resize_crop_cameras_u8", "depth_maps"):
        assert callable(getattr(native, name))
    assert native.library() is not None


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    from hipad_torch.ops import kernels

    fm = torch.zeros(2, 4, 5, 32)
    px = torch.zeros(2, 7)
    wg = torch.ones(2, 7, 4)
    fine = [torch.zeros(1, 2, 4, 5, 32)]
    cam = torch.zeros(1, 6, dtype=torch.int32)
    x, w = torch.zeros(1, 6), torch.ones(1, 6, 1, 4)
    pts, wts = torch.full((1, 3, 2, 2), 0.5), torch.ones(1, 3, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.coarse_sample(torch.zeros(1, 3, 32), fine, pts, wts, [2])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.coarse_sample(None, fine, pts, wts, [2])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.interp_sample_camsum_bwd(fm, px, px, wg, torch.zeros(1, 7, 32), 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.patch_sample(fine, cam, x, x, w, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.patch_sample_bwd(fine, cam, x, x, w, torch.zeros(1, 3, 32), 2)
    lvl = torch.zeros(1, 6, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.patch_sample_lk(fine, cam, x, x, w, 2, lvl)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.patch_sample_bwd_lk(fine, cam, x, x, w, torch.zeros(1, 3, 32), 2, lvl)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lsa_assign([(torch.zeros(2, 3, 5), torch.ones(2, 3, dtype=torch.bool))])
    for k in kernels.KERNELS:
        assert k.launches == 0, k.name


def test_no_wrapper_adds_with_atomics_under_the_deterministic_flag(monkeypatch):
    """Every wrapper of ``ops/kernels.py`` declares its routes, and each call
    launches the one its ``route()`` reads from torch's deterministic flag:
    under ``torch.use_deterministic_algorithms(True)`` never a route that
    adds with float atomics into an output several threads share (a wrapper
    with only such routes raises, naming its kernel), without it the first
    route. Read from the declared routes, whatever the CUDA sources say."""
    from hipad_torch.ops import kernels

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        for k in kernels.WRAPPERS:
            assert k.routes and all(isinstance(r, kernels.Route) for r in k.routes), k.name
            seen = []
            monkeypatch.setattr(k, "launch", lambda route, *a: seen.append(route))
            torch.use_deterministic_algorithms(False)
            k("inputs")
            torch.use_deterministic_algorithms(True)
            if all(r.atomic for r in k.routes):
                with pytest.raises(RuntimeError, match=k.name):
                    k("inputs")
                continue
            k("inputs")
            assert seen[0] == k.routes[0], k.name
            assert not seen[1].atomic and seen[1] in k.routes, (k.name, seen[1])
        # every launch count of the kernel table: a wrapper's, or one of its
        # routes' beside it
        assert {c.name for c in kernels.KERNELS} == {k.name for k in kernels.WRAPPERS} | {
            f"{k.name}_{r.name}" for k in kernels.WRAPPERS for r in k.routes[1:]}
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("config", ["stage2", "stage2_serving_det", "tiny"])
def test_launch_plan_counts_one_k1_launch_per_call(config):
    """``chip_smoke.py`` holds each path's launches to its op program: per
    deformable call one K1 for all coarse levels, one K2 for all fine
    levels, one K1-bwd per coarse level and one K2-bwd."""
    import chip_smoke
    from hipad_torch.configs import model as configs

    cfg = getattr(configs, config)()
    n_deform, per_call = chip_smoke._launch_plan(cfg)
    assert n_deform == cfg.operation_order.count("deformable") * len(cfg.query_select)
    coarse = [l for l in cfg.sampler_matmul_levels if l < cfg.num_levels]
    assert per_call == {"coarse_sample": 1, "patch_sample": 1,
                        "interp_sample_camsum_bwd": len(coarse), "patch_sample_bwd": 1}
    if config != "tiny":
        assert (n_deform, len(coarse)) == (24, 2)


def test_model_is_built_on_the_card_by_default():
    """``HiPAD(cfg)`` asks for the card; only ``device="cpu"`` gives a CPU
    model. On a host without CUDA the default therefore fails."""
    from hipad_torch.configs.model import tiny
    from hipad_torch.models.detector import HiPAD

    if torch.cuda.is_available():
        assert next(HiPAD(tiny()).parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            HiPAD(tiny())
    assert next(HiPAD(tiny(), device="cpu").parameters()).device.type == "cpu"


def test_models_never_import_the_losses():
    """The model is a function of weights and inputs: nothing under
    ``hipad_torch/models/`` imports ``hipad_torch.losses`` (the depth loss
    lives in ``losses/depth.py``), and the losses hold no process group of
    their own: the data-parallel group is an argument."""
    pat = re.compile(r"^\s*from\s+(\.\.losses|hipad_torch\.losses)\b|"
                     r"^\s*import\s+hipad_torch\.losses\b", re.M)
    models = ROOT / "hipad_torch" / "models"
    offenders = [p.name for p in models.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders
    from hipad_torch.losses import common

    assert not hasattr(common, "_GROUP") and not hasattr(common, "global_batch")


@pytest.mark.parametrize("option,refused", [
    ({"with_topk_det": True, "topk_det_list": (6, 6)}, True),  # prunes at the merge layer
    ({"with_topk_det": True, "topk_det_list": (12, 12, 6)}, True),  # after the last layer
    ({"sampler_row_packed": True}, True),
    ({"fused_deformable": True}, True),
    ({"with_distance_attn_mask": True, "with_velocity_attn_mask": True}, False),
    ({"with_concat_map_points": True, "with_concat_plan_points": True}, False),
    ({"with_deform_map_points": True, "with_deform_plan_points": True}, False),
    ({"sampler_level_k": 1}, False),
    ({"sampler": "reference"}, False),
])
def test_check_supported_refuses_only_the_unported_options(option, refused):
    """The row-packed and fused samplers (not ported) and the two det
    pruning schedules the JAX package gets wrong are refused by name; the
    masks, point expansion, the level top-k and the oracle sampler run."""
    from hipad_torch.configs.model import SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER, tiny
    from hipad_torch.models.decoder import check_supported

    if len(option.get("topk_det_list", ())) == 3:
        option = dict(option, operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2)
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_supported(tiny(**option))
    else:
        check_supported(tiny(**option))
