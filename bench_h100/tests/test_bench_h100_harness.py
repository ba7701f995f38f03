"""The harness end to end on the CPU at tiny sizes: cells found by name, a
sound run reads correct, the control and each planted fault read
incorrect, and the no-JAX check."""

import json
import sys
import time

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
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


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


def test_finds_a_new_cell_by_name(tiny_root, tmp_path):
    """A configuration, a traffic mix and a metric reader added as files
    alone are found by the names that BENCHMARK.json gives them."""
    import shutil

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    base = root / "bench_h100"
    (base / "configs" / "dummy.json").write_text((base / "configs" / "tiny6.json").read_text())
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
