"""The harness end to end on the CPU at tiny sizes: cells found by name, a
sound run reads correct, the control and each planted fault read
incorrect, and the no-JAX check."""

import dataclasses
import json
import sys
import time

import numpy as np
import pytest

import torch

from bench_h100.harness import check, hygiene, runner, spec

SEED = 2 ** 31 + 977  # more than 32 signed bits hold


def _run(root, cell, **kw):
    return runner.execute(spec.load_cell(cell, root), SEED, 1.0, False, "cpu",
                          time.perf_counter(), **kw)


def test_sound_run_is_correct(tiny_root):
    res = _run(tiny_root, "tiny.frame")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    # device_ms_per_frame reads the card's trace: on the CPU it is left out
    assert set(res["metrics"]) == {"setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_readers_take_the_profiled_stretch():
    """The end-to-end card time a frame and the per-layer frame rate and
    busy-time MFU, from a hand-made run; nothing where there is no trace."""
    cell = spec.load_cell("stage2.frame")
    flops = cell.config["model_flops_per_frame"]
    run = runner.Run(cell, 12.0, 40.0, [0.1] * 400,
                     trace={"busy_s": 0.093, "units": 3, "window_s": 0.62})
    read = {m["name"]: spec.reader(kind, m["name"])(run)
            for kind, ms in (("end_to_end", cell.end_to_end), ("layers", cell.per_layer))
            for m in ms}
    assert read["device_ms_per_frame"] == pytest.approx(31.0)
    assert read["frames_per_s.frame"] == pytest.approx(10.0)
    assert read["mfu_busy.frame"] == pytest.approx(100 * flops / 0.031 / 989e12)
    assert 0 < read["mfu.frame"] < read["mfu_busy.frame"] < 100
    assert read["device_idle.frame"] == pytest.approx(69.0)
    bare = runner.Run(cell, 12.0, 40.0, [0.1] * 400)
    for name in ("device_ms_per_frame", "mfu_busy.frame"):
        kind = "end_to_end" if name == "device_ms_per_frame" else "layers"
        assert spec.reader(kind, name)(bare) is None


@pytest.mark.parametrize("kw", [
    {"control": "fp8"},
    {"fault": "state"},
    {"fault": "rows"},
    {"fault": "camera"},
    {"fault": "answer"},
    {"fault": "mode"},
])
def test_control_and_faults_are_incorrect(tiny_root, kw):
    res = _run(tiny_root, "tiny.frame", **kw)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("size", [(352, 640), (704, 1280)])
def test_finds_a_new_cell_by_name(tiny_root, tmp_path, size):
    """A configuration, a traffic mix and a metric reader added as files
    alone are found by the names that BENCHMARK.json gives them, and the
    cell runs correct; a configuration at another input size (the tiny one
    at 704x1280, as ``stage2_r101_2x`` runs) brings its images and camera
    projection with it."""
    import shutil

    from bench_h100.harness import traffic
    from hipad_torch.configs import model as configs

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    base = root / "bench_h100"
    entry = json.loads((base / "configs" / "tiny6.json").read_text())
    entry["overrides"]["input_size"] = list(size)
    entry["fields"] = spec.config_fields(configs.tiny(num_cams=6, input_size=size))
    (base / "configs" / "dummy.json").write_text(json.dumps(entry))
    mix = json.loads((base / "traffic" / "stream_frames.json").read_text())
    mix["route"]["speed"] = 2.0
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (base / "limits" / "dummy.frame.json").write_text(
        (base / "limits" / "tiny.frame.json").read_text())
    (base / "end_to_end").mkdir()
    (base / "end_to_end" / "dummy_units.py").write_text("def read(run):\n    return run.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dummy",
                                 file="bench_h100/configs/dummy.json"))
    bench["workloads"].append({"name": "dummy.frame", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "dummy_units", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["dummy.frame"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("dummy.frame", root)
    assert cell.traffic["route"]["speed"] == 2.0
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "dummy_units"]
    assert spec.reader("end_to_end", "dummy_units", root)(runner.Run(cell, 0, 1, [1, 1])) == 2
    with pytest.raises(SystemExit):
        spec.reader("layers", "no_such_metric", root)
    h, w = size
    cfg = spec.program_config(cell.config)
    assert tuple(cfg.input_size) == (h, w)
    images, metas = traffic.StreamFrames(cell.traffic, cfg, SEED, "cpu").frame(0)
    assert images.shape == (1, 6, h, w, 3)
    assert np.array_equal(metas["image_wh"][0], np.full((6, 2), (w, h), np.float32))
    # the run reads its metrics with the repo's readers: setup_s alone here
    res = runner.execute(dataclasses.replace(cell, end_to_end=cell.end_to_end[:1]), SEED, 1.0,
                         False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]


def test_no_jax_check_compares_whole_top_level_names():
    assert hygiene.forbidden_modules(["hipad_tpu.models", "numpy"]) == ["hipad_tpu"]
    assert hygiene.forbidden_modules(["jax", "jax.numpy", "torch"]) == ["jax"]
    assert hygiene.forbidden_modules(["hipad_torch", "hipad_torch.ops", "jaxtyping",
                                      "flaxen"]) == []
    assert hygiene.forbidden_modules() == [] or "jax" not in sys.modules


def test_program_config_is_held_to_its_file():
    entry = spec.load_json(spec.HERE / "configs" / "stage2.json")
    bad = dict(entry, fields=dict(entry["fields"], num_det_anchor=901))
    with pytest.raises(SystemExit, match="num_det_anchor"):
        spec.program_config(bad)
    # a field the file does not state (an option the program gains later)
    # runs at the factory's value
    fewer = dict(entry, fields={k: v for k, v in entry["fields"].items()
                                if k != "sampler_cam_k"})
    assert spec.program_config(fewer).sampler_cam_k == entry["fields"]["sampler_cam_k"]
    ref = spec.reference_config(entry)
    assert spec.config_fields(ref) == entry["fields"]


def test_rows_are_paired_one_to_one():
    """Reordered rows read 0; duplicated rows find no partner of their own,
    where matching each row to its nearest reads them as 0 too."""
    g = torch.Generator().manual_seed(0)
    ref = [torch.randn(64, 8, generator=g), torch.randn(64, 3, generator=g)]
    perm = torch.randperm(64, generator=g)
    whole, parts = check.paired_errors([t[perm] for t in ref], ref)
    assert float(whole.max()) < 1e-12 and all(float(p.max()) < 1e-12 for p in parts)
    dup = [t.clone() for t in ref]
    for t in dup:
        t[1::8] = t[0::8]
    whole, _ = check.paired_errors(dup, ref)
    assert int((whole > 0.3).sum()) >= 8
    assert check.quantile(whole, 0.95) > 0.3 > check.quantile(whole, 0.5)
