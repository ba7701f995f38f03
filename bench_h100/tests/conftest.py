"""The benchmark's own tests: on the CPU at tiny sizes, without JAX.

    python -m pytest bench_h100/tests -q

Tests marked ``card`` need a CUDA device and skip without one (the
``card`` fixture decides, never while a module is imported)."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_LIMITS = {"det_err": 1e-4, "map_err": 1e-4, "bank_err": 1e-4, "decode_err": 0.0,
               "plan_gap": 1e-4}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout-like root with the frame cell at ``tiny()`` widths (six
    cameras at 352x640, the CARLA rig's), fp32, small camera frames, and
    limits for an exact comparison."""
    from bench_h100.harness import spec
    from hipad_torch.configs import model as configs

    root = tmp_path_factory.mktemp("bench")
    base = root / "bench_h100"
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True)
    over = {"num_cams": 6, "input_size": [352, 640]}
    cfg = configs.tiny(num_cams=6, input_size=(352, 640))
    (base / "configs" / "tiny6.json").write_text(json.dumps(
        {"name": "tiny6", "factory": "tiny", "anchors": "synthetic", "overrides": over,
         "fields": spec.config_fields(cfg)}))
    frames = spec.load_json(spec.HERE / "traffic" / "stream_frames.json")
    frames["cameras"].update(pool=3, shapes=8)
    frames.update(dtype="fp32", check_units=2)
    (base / "traffic" / "stream_frames.json").write_text(json.dumps(frames))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["configs"] = [{"name": "tiny6", "source": "tiny()", "why": "tests",
                         "file": "bench_h100/configs/tiny6.json", "reduced": []}]
    bench["workloads"] = [{"name": "tiny.frame", "config": "tiny6", "traffic": "stream_frames",
                           "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny." + m["workloads"][0].rsplit(".", 1)[1]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (base / "limits" / "tiny.frame.json").write_text(json.dumps(TINY_LIMITS))
    return root
