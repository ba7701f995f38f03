"""One run of one cell: set-up, the measured window, the traced stretches
(``--trace 1``), the program freed, the reference's check, and the result
line.

The window runs whole units until ``--seconds`` have passed; a rate or a
time per unit is taken over every unit and the whole window, a percentile
over every unit's wall. A short profiled stretch follows the window on the
card (the device's busy time a unit); with ``--trace 1`` it also opens the
sampler's ranges, and a short stretch under the sync debug mode follows it.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from . import cells, check, hygiene, spec, trace


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    window_s: float
    walls: List[float]  # every window unit's wall, seconds
    trace: Optional[Dict] = None  # the profiled stretch
    syncs: Optional[Dict] = None  # the sync-debug stretch

    @property
    def units(self) -> int:
        return len(self.walls)

    def quantile(self, q: float) -> float:
        """The ``q`` quantile of the walls (``statistics.quantiles``, n=100)."""
        if len(self.walls) < 2:
            return self.walls[0]
        return statistics.quantiles(self.walls, n=100, method="inclusive")[round(q * 100) - 1]


def device_info(device: torch.device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            control: Optional[str] = None, fault: Optional[str] = None, log=sys.stderr) -> Dict:
    """-> the result line's object."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    drv = cells.driver(cell, seed, device, control=control, fault=fault)
    drv.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    walls: List[float] = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        drv.unit()
        b = time.perf_counter()
        walls.append(b - a)
        if b - t0 >= seconds:
            break
    run = Run(cell, setup_s, b - t0, walls)

    def units(n):
        def go():
            for _ in range(n):
                drv.unit(capture=False)
            return n
        return go

    n_prof = cell.traffic["profiled_units"]
    if traced:
        run.trace = trace.profile(units(n_prof))
        run.syncs = trace.count_syncs(units(cell.traffic["sync_units"]))
    elif cuda:
        # the card's busy time a unit, which the end-to-end readers take
        run.trace = trace.profile(units(n_prof), with_sampler=False)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    t_check = time.perf_counter()
    values = drv.check()
    readings = check.judge(values, cell.limits)
    check_s = time.perf_counter() - t_check

    metrics: Dict[str, Dict] = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.reader("layers" if traced else "end_to_end", m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(device, peak)
    result = {"correct": all(r.ok for r in readings), "attempted": run.units,
              "failed": 0 if all(r.ok for r in readings) else 1,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    half = run.units // 2
    print(f"[run] {cell.name} seed {seed}: set-up {setup_s:.3f} s, {run.units} units in "
          f"{run.window_s:.3f} s (unit wall ms p10/p50/p90 "
          f"{1e3 * run.quantile(0.1):.1f}/{1e3 * run.quantile(0.5):.1f}/"
          f"{1e3 * run.quantile(0.9):.1f}, first/second half mean "
          f"{1e3 * sum(walls[:half]) / max(half, 1):.1f}/"
          f"{1e3 * sum(walls[half:]) / max(run.units - half, 1):.1f}), check {check_s:.3f} s",
          file=log)
    if run.trace is not None:
        print(f"[run] trace: {json.dumps({k: v for k, v in run.trace.items() if k not in ('device_ops', 'idle_gaps')})}", file=log)
    if run.syncs is not None:
        print(f"[run] syncs: {json.dumps(run.syncs)}", file=log)
    for d in drv.diag:
        print(f"[diag] {json.dumps(d)}", file=log)
    result["checks"] = {r.name: {"value": r.value, "limit": r.limit} for r in readings}
    for r in readings:
        print(f"check {r.name} {r.value!r} limit {r.limit!r} {'ok' if r.ok else 'FAIL'}",
              file=log)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_const", const="fp8",
                    help="the reference in fp8 in the program's place (must read incorrect)")
    ap.add_argument("--fault", choices=("state", "rows", "camera", "answer", "mode"),
                    help="a planted fault in the timed path (must read incorrect)")
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"{args.workload} needs {cell.spec['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                     control=args.control, fault=args.fault)
    bad = hygiene.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures hipad_torch without JAX",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
