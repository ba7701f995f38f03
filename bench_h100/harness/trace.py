"""The traced run's stretches after the window: a short one under
``torch.profiler`` (CPU and CUDA) and a short one under
``torch.cuda.set_sync_debug_mode("warn")``, and what is read from them.

Device time comes from the profiler's Chrome trace: the device operations'
intervals (kernels, copies, fills), merged where they overlap as
``hipad_torch/probe.py``'s ``_merged_busy`` merges them. The sampler's
device time is the time of the operations launched inside the ranges that
the benchmark opens around the program's ``ops.sampling.coarse_sample``
and ``patch_sample`` entries while the stretch is profiled; its least time
comes from the arguments of those same calls (``counts/taps.py``).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import traceback
import warnings
from typing import Callable, Dict, List

import torch

from ..counts import taps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the ranges whose device time is read: the benchmark's own around the two
# forward entries
RANGES = {"sampler_fwd": ("bench::coarse_sample", "bench::patch_sample")}


def merged_busy(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def merged(intervals) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class SamplerTap:
    """Wraps the program's two sampler entries while it is installed: each
    call runs inside a named profiler range, and its arguments are kept for
    the byte and operation counts."""

    def __init__(self):
        from hipad_torch.ops import sampling

        self.sampling = sampling
        self.calls: List[tuple] = []
        self.orig = {n: getattr(sampling, n) for n in ("coarse_sample", "patch_sample")}

    def __enter__(self):
        def wrap(name, fn):
            def wrapped(*args, **kwargs):
                self.calls.append((name, args, kwargs))
                with torch.profiler.record_function(f"bench::{name}"):
                    return fn(*args, **kwargs)
            return wrapped

        for n, fn in self.orig.items():
            setattr(self.sampling, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.sampling, n, fn)

    def least_seconds(self) -> Dict[str, float]:
        """Sum over the kept calls of their least time on the card."""
        total = {"sampler_fwd": 0.0}
        for name, args, kwargs in self.calls:
            if name == "coarse_sample":
                acc, maps, pts, weights, levels = args
                total["sampler_fwd"] += taps.bound(*taps.coarse_sample_work(
                    acc, maps, pts, weights, levels))[0]
            else:
                maps, cam, x, y, w, cam_k = args[:6]
                lvl = args[6] if len(args) > 6 else kwargs.get("lvl")
                total["sampler_fwd"] += taps.bound(*taps.patch_sample_work(
                    maps, cam, x, y, w, cam_k, lvl))[0]
        return total


def profile(run_units: Callable[[], int], with_sampler: bool = True) -> Dict:
    """Profile ``run_units()`` (which returns how many units it ran) ->
    the trace's readings."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    tap = SamplerTap() if with_sampler else None
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if tap is not None:
            with tap:
                n = run_units()
        else:
            n = run_units()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = read_trace(events)
    out["units"] = n
    if tap is not None:
        out["least_s"] = tap.least_seconds()
        out["sampler_calls"] = len(tap.calls)
    return out


def read_trace(events: List[Dict]) -> Dict:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = merged_busy(iv) * 1e-6
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")]
    t0 = min([s for s, _ in iv] + [e["ts"] for e in host])
    t1 = max([e for _, e in iv] + [e["ts"] + e["dur"] for e in host])

    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    ops = [[n[:200], s] for n, s in by_name.most_common(10)]

    # device time of the operations launched inside the named ranges
    launches = [e for e in host if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    launches.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in launches]
    by_corr = {e["args"]["correlation"]: e for e in dev if "correlation" in e.get("args", {})}
    device_s, n_ranges = {}, {}
    for key, names in RANGES.items():
        spans = [e for e in host if e["cat"] in ("user_annotation", "cpu_op")
                 and any(n in e["name"] for n in names)]
        n_ranges[key] = len(spans)
        total = 0.0
        for r in spans:
            lo, hi = r["ts"], r["ts"] + r["dur"]
            for j in range(bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)):
                l = launches[j]
                k = by_corr.get(l["args"]["correlation"]) if l["tid"] == r["tid"] else None
                if k is not None:
                    total += k["dur"] * 1e-6
        device_s[key] = total

    # the longest idle gaps, by what the host was doing in them
    spans = merged(iv)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    cpu = [e for e in host if e["cat"] in ("cpu_op", "user_annotation", "python_function")]
    idle = []
    for length, lo, hi in gaps[:10]:
        mid = (lo + hi) / 2
        around = [e for e in cpu if e["ts"] <= mid <= e["ts"] + e["dur"]]
        inner = min(around, key=lambda e: e["dur"])["name"] if around else "no host op"
        idle.append([inner[:200], length * 1e-6])
    return {"busy_s": busy, "window_s": (t1 - t0) * 1e-6, "device_s": device_s,
            "ranges": n_ranges, "device_ops": ops, "idle_gaps": idle}


def count_syncs(run_units: Callable[[], int]) -> Dict:
    """Synchronizing calls under ``set_sync_debug_mode("warn")``, by site
    (the innermost frame in the program, else the innermost frame), as
    ``chip_smoke.py``'s ``_sync_sites`` counts them."""
    sites = collections.Counter()
    inside = False

    def show(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not os.path.basename(f.filename).startswith("warnings")]
        port = [f for f in frames if f"{os.sep}hipad_torch{os.sep}" in f.filename]
        f = (port or frames)[-1]
        sites["/".join(f.filename.rsplit(os.sep, 2)[-2:]) + f":{f.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old, warnings.showwarning = warnings.showwarning, show
        torch.cuda.set_sync_debug_mode("warn")
        inside = True
        try:
            n = run_units()
        finally:
            inside = False
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    torch.cuda.synchronize()
    return {"syncs": sum(sites.values()), "units": n, "sites": dict(sites.most_common(10))}
