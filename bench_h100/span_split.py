"""Where a cell's frame goes, by the program's own spans, on one card:

    python3 bench_h100/span_split.py --workload stage2.frame --seed <n>

After the cell's set-up (its warm-up included) it runs, in one process:

1. one frame three times from the same banks, spans off, off and on: the
   outputs, banks and host results compared bit for bit;
2. ``--pairs`` pairs of ``--window``-second windows, spans off and under
   ``recording()`` in turns (the first of each pair alternating): each
   window's mean frame wall, and the on-cost a pair;
3. the span stretch: ``--units`` frames under ``recording()``, no profiler
   (host ms, self ms and calls a frame by span, ``harness/spans.host_split``);
4. the profiled stretch: ``--profiled`` frames under ``torch.profiler`` and
   ``recording()`` (``trace.read_trace`` and ``harness/spans.read_events``:
   device ms, launches and idle by span, coverage);
5. ``--sync`` frames under ``set_sync_debug_mode("warn")`` twice, spans off
   and on (``trace.count_syncs``): the waits by site.

Standard error gets one ``[split]`` line a step and ``[run] spans:``; the
last line of standard output is the whole result as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _leaves(y)]
    if hasattr(x, "__dataclass_fields__"):
        return [v for k in sorted(x.__dataclass_fields__) for v in _leaves(getattr(x, k))]
    return [x]


def _equal(a, b) -> bool:
    import numpy as np
    import torch

    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def _quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"q1": q[0], "median": q[1], "q3": q[2]}


def frame(drv, banks):
    """One frame of the stream-frames cell from ``banks`` -> (outputs, new
    banks, host results), as ``StreamFramesDriver.unit`` runs it."""
    import torch

    images_host, metas_np = drv.traffic.frame(drv.i)
    images = images_host.to(drv.device, non_blocking=True)
    metas = {k: torch.from_numpy(v).to(drv.device, non_blocking=True)
             for k, v in metas_np.items()}
    with torch.no_grad(), torch.autocast(drv.device.type, dtype=torch.bfloat16,
                                         enabled=drv.autocast):
        outputs, new_banks = drv.model(images, metas, banks)
    with torch.no_grad():
        decoded = drv.post(drv.cfg, drv.to_float32(outputs), metas["gt_ego_fut_cmd"])
    return outputs, new_banks, drv.to_host(decoded)


def split(drv, units: int, profiled: int, sync: int, pairs: int, window: float,
          log=sys.stderr) -> dict:
    import torch

    from bench_h100.harness import spans as read_spans
    from bench_h100.harness import trace
    from hipad_torch.utils import spans

    cuda = drv.device.type == "cuda"
    out = {}

    # 1. bit for bit, off / off / on from one set of banks
    banks = drv.banks
    a, b = frame(drv, banks), frame(drv, banks)
    with spans.recording():
        c = frame(drv, banks)
    out["identical"] = {"off_off": _equal(a, b), "off_on": _equal(a, c)}
    print(f"[split] identical {json.dumps(out['identical'])}", file=log)

    # 2. on-cost: windows off and on in turns
    def window_ms(on: bool) -> float:
        n, t0 = 0, time.perf_counter()
        if on:
            with spans.recording():
                while time.perf_counter() - t0 < window:
                    drv.unit(capture=False)
                    n += 1
        else:
            while time.perf_counter() - t0 < window:
                drv.unit(capture=False)
                n += 1
        return (time.perf_counter() - t0) * 1e3 / n

    off_ms, on_ms = [], []
    for p in range(pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            (on_ms if on else off_ms).append(window_ms(on))
    if pairs:
        cost = [x - y for x, y in zip(on_ms, off_ms)]
        out["on_cost"] = {"off_ms": off_ms, "on_ms": on_ms, "cost_ms": cost,
                          "cost": _quartiles(cost)}
        print(f"[split] on-cost {json.dumps(out['on_cost'])}", file=log)

    # 3. the span stretch: host times, no profiler
    with spans.recording() as rec:
        for _ in range(units):
            with rec.unit():
                drv.unit(capture=False)
    host = read_spans.host_split(rec)
    out["host"] = host

    # 4. the profiled stretch, spans on
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof, spans.recording():
        for _ in range(profiled):
            drv.unit(capture=False)
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = read_spans.read_events(events, profiled)
    base = trace.read_trace(events)
    out["device"] = dev
    out["trace"] = {k: base[k] for k in ("busy_s", "window_s", "device_ops", "idle_gaps")}

    # 5. waits for the host, spans off and on
    if cuda:
        def go(on):
            def run():
                if on:
                    with spans.recording():
                        for _ in range(sync):
                            drv.unit(capture=False)
                else:
                    for _ in range(sync):
                        drv.unit(capture=False)
                return sync
            return run

        out["syncs"] = {"off": trace.count_syncs(go(False)), "on": trace.count_syncs(go(True))}
        print(f"[split] syncs {json.dumps(out['syncs'])}", file=log)

    # the nine layer numbers a frame, as the benchmark's readers would take them
    layers = read_spans.layer_device(dev["paths"])
    out["layers"] = {}
    for layer in read_spans.LAYERS:
        out["layers"][f"{layer}_host_ms.frame"] = host["layers"][layer]
        out["layers"][f"{layer}_device_ms.frame"] = layers[layer]["device_ms"]
        out["layers"][f"{layer}_launches.frame"] = layers[layer]["launches"]
    names = read_spans.by_name(dev["paths"])
    table = {n: {"host_ms": r["incl_ms"], "self_ms": r["self_ms"], "calls": r["calls"],
                 "device_ms": names.get(n, {}).get("device_ms", 0.0),
                 "launches": names.get(n, {}).get("launches", 0.0),
                 "idle_ms": names.get(n, {}).get("idle_ms", 0.0)}
             for n, r in host["names"].items()}
    table[read_spans.OUTSIDE] = {k: names.get(read_spans.OUTSIDE, {}).get(k, 0.0)
                                 for k in ("device_ms", "launches", "idle_ms")}
    out["names"] = table
    line = {"per_frame": table, "layers": out["layers"],
            "idle_ms_by_layer": {k: v["idle_ms"] for k, v in layers.items()},
            "coverage": dict(dev["coverage"], top_level_wall=host["top_level_share"]),
            "unit_wall_ms": host["unit_wall_ms"], "busy_ms": dev["busy_ms"],
            "idle_ms": dev["idle_ms"]}
    print(f"[run] spans: {json.dumps(line)}", file=log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="A cell's frame split by the program's spans.")
    ap.add_argument("--workload", default="stage2.frame")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--sync", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--window", type=float, default=10.0)
    ap.add_argument("--out", help="also write the result's JSON here")
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness import cells, spec

    if not torch.cuda.is_available():
        print("the split needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    drv = cells.driver(cell, args.seed, "cuda")
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"[split] {args.workload} seed {args.seed}: set-up {setup_s:.3f} s on "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    result = {"workload": args.workload, "seed": args.seed, "setup_s": setup_s,
              "device": torch.cuda.get_device_name(0),
              **split(drv, args.units, args.profiled, args.sync, args.pairs, args.window)}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
