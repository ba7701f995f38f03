"""What a cell is made of, found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), and
the reader of each metric (``end_to_end/<metric>.py``,
``layers/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
KMEANS_DIR = HERE / "configs" / "kmeans"


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: Dict  # the entry of BENCHMARK.json's workloads
    config: Dict  # configs/<config>.json
    traffic: Dict  # traffic/<traffic>.json
    limits: Dict[str, float]  # limits/<cell>.json
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; its files lie under
    ``root/bench_h100``."""
    bench = load_json(root / "BENCHMARK.json")
    base = root / HERE.name
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
    return Cell(
        name=name, spec=spec, config=load_json(root / cfg_entry["file"]),
        traffic=load_json(base / "traffic" / f"{spec['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(kind: str, metric: str, root: pathlib.Path = ROOT) -> Callable:
    """The ``read(run) -> float | None`` of ``<kind>/<metric>.py``."""
    base = root / HERE.name
    path = base / kind / f"{metric}.py"
    mod_name = f"bench_h100_{kind}_{metric.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise SystemExit(f"no reader {path.relative_to(base.parent)} for metric {metric!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- configurations ------------------------------------------------------

def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


ANCHORS = ("det_anchor", "map_anchor", "motion_anchor", "plan_anchor")


def config_fields(cfg) -> Dict:
    """A config dataclass -> its fields as JSON values, anchors left out."""
    return {f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
            if f.name not in ANCHORS}


def program_config(entry: Dict):
    """The program's configuration: its factory over the benchmark's anchor
    files, held to every field the configuration's file states (a field the
    program gains later runs at its factory's value)."""
    from hipad_torch.configs import model as configs

    kw = dict(entry.get("overrides", {}))
    if entry.get("anchors", "kmeans") == "kmeans":
        kw["kmeans_dir"] = str(KMEANS_DIR)
    cfg = getattr(configs, entry["factory"])(**{k: _tuples(v) for k, v in kw.items()})
    got = config_fields(cfg)
    diff = sorted(k for k, v in entry["fields"].items() if got.get(k) != v)
    if diff:
        raise SystemExit(f"the program's {entry['factory']}() differs from the configuration's "
                         f"file in {diff}")
    return cfg


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def reference_config(entry: Dict):
    """The reference's configuration, from the file's fields alone."""
    from ..reference.hipad.configs import model as ref

    kw = {}
    for k, v in entry["fields"].items():
        if k in ("det_kps", "ego_kps"):
            v = ref.KeypointSpec(_tuples(v["fix_scale"]), v["num_learnable"])
        elif k in ("map_kps", "plan_kps"):
            v = ref.PointKeypointSpec(v["num_sample"], v["num_learnable"],
                                      _tuples(v["fix_height"]), v["ground_height"])
        else:
            v = _tuples(v)
        kw[k] = v
    if entry.get("anchors", "kmeans") == "kmeans":
        det, mapa, motion, plan = ref.load_anchors(str(KMEANS_DIR), kw)
    else:  # the stand-ins of the test configuration
        det, mapa, motion, plan = ref._synthetic_anchors(kw, np.random.RandomState(0))
    return ref.HiPADConfig(det_anchor=np.asarray(det), map_anchor=mapa, motion_anchor=motion,
                           plan_anchor=plan, **kw)
