"""The program's own spans (``hipad_torch/utils/spans.py``), read two ways.

* Host: a stretch of units under ``spans.recording()`` with no profiler.
  Per span name, the median over the units of the unit's inclusive and self
  time and calls (:func:`host_split`).
* Device: a profiled stretch under ``spans.recording()``, where each span
  lies in the Chrome trace as a ``hipad::<name>`` ``user_annotation`` on the
  host thread that opened it (:func:`read_events`). Each device operation
  (kernel, copy, fill) goes to the innermost span that was open on that
  thread when the runtime call that launched it (matched by ``correlation``)
  was made; a launch from another thread, or from no span, goes to
  ``outside``. The device's idle time (the window less its merged busy
  intervals, the window as ``trace.read_trace`` takes it) is split over the
  innermost span open on the host at each instant.

Spans are keyed by their path, the names from the top-level span down
joined by ``/``; :data:`LAYERS` says which top-level names make each layer.
The profiler slows the host, so the profiled stretch gives device times,
launches and the shares of idle time, not host times.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, List, Tuple

from .trace import DEVICE_CATS, merged, merged_busy

PREFIX = "hipad::"
OUTSIDE = "outside"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function") + RUNTIME_CATS
# layer -> the span names whose subtrees make it
LAYERS = {"backbone": ("backbone",), "decoder": ("decoder",),
          "postprocess": ("postprocess", "to_host")}


def _thread_spans(events: List[Dict]) -> Tuple[object, List[tuple]]:
    """The host thread with the most program spans, and its spans as
    ``(start, end, path)`` in opening order (spans of one thread nest)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith(PREFIX):
            by_tid[e["tid"]].append(e)
    if not by_tid:
        return None, []
    tid = max(by_tid, key=lambda t: len(by_tid[t]))
    out, stack = [], []
    for e in sorted(by_tid[tid], key=lambda e: (e["ts"], -e["dur"])):
        s, t = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1][1] <= s:
            stack.pop()
        path = (stack[-1][2] + "/" if stack else "") + e["name"][len(PREFIX):]
        out.append((s, t, path))
        stack.append((s, t, path))
    return tid, out


def innermost_segments(spans: List[tuple]) -> List[tuple]:
    """Nested ``(start, end, path)`` spans in opening order -> the
    ``(start, end, path)`` pieces of time in which ``path`` is the innermost
    open span, in order and not overlapping."""
    segs: List[tuple] = []
    stack: List[tuple] = []  # (end, path)
    cur = None

    def advance(to):
        nonlocal cur
        if stack and to > cur:
            segs.append((cur, to, stack[-1][1]))
        cur = to if cur is None else max(cur, to)

    for s, e, path in spans:
        while stack and stack[-1][0] <= s:
            advance(stack[-1][0])
            stack.pop()
        advance(s)
        stack.append((e, path))
    while stack:
        advance(stack[-1][0])
        stack.pop()
    return segs


def _path_at(segs: List[tuple], starts: List[float], t: float) -> str:
    j = bisect.bisect_right(starts, t) - 1
    return segs[j][2] if j >= 0 and t <= segs[j][1] else OUTSIDE


def read_events(events: List[Dict], units: int) -> Dict:
    """A profiled stretch of ``units`` units -> per span path a unit's
    ``device_ms`` and ``launches`` (the innermost span's alone) and
    ``idle_ms``; ``outside`` for what no span holds; ``coverage``, the shares
    of device time and of launches inside a program span."""
    tid, spans = _thread_spans(events)
    segs = innermost_segments(spans)
    starts = [s for s, _, _ in segs]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_corr = collections.defaultdict(float)
    for e in dev:
        if "correlation" in e.get("args", {}):
            by_corr[e["args"]["correlation"]] += e["dur"]
    rows = collections.defaultdict(lambda: {"device_ms": 0.0, "launches": 0.0, "idle_ms": 0.0})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in RUNTIME_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr not in by_corr:
            continue  # a call that launched nothing (a sync, an event query)
        path = _path_at(segs, starts, e["ts"]) if e["tid"] == tid else OUTSIDE
        rows[path]["device_ms"] += by_corr.pop(corr) * 1e-3
        rows[path]["launches"] += 1
    for us in by_corr.values():  # device work whose launch the trace lacks
        rows[OUTSIDE]["device_ms"] += us * 1e-3

    # idle: the window less the merged busy intervals, by innermost span
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    t0 = min([s for s, _ in iv] + [e["ts"] for e in host])
    t1 = max([t for _, t in iv] + [e["ts"] + e["dur"] for e in host])
    busy = merged(iv)
    edges = [t0] + [x for b in busy for x in b] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle_total = sum(b - a for a, b in idle)
    j, held = 0, 0.0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            part = min(b, segs[k][1]) - max(a, segs[k][0])
            if part > 0:
                rows[segs[k][2]]["idle_ms"] += part * 1e-3
                held += part
            k += 1
    rows[OUTSIDE]["idle_ms"] += (idle_total - held) * 1e-3

    out = {p: {k: v / units for k, v in r.items()} for p, r in rows.items()}
    out.setdefault(OUTSIDE, {"device_ms": 0.0, "launches": 0.0, "idle_ms": 0.0})
    dev_ms = sum(r["device_ms"] for r in out.values())
    launches = sum(r["launches"] for r in out.values())
    inside = {p: r for p, r in out.items() if p != OUTSIDE}
    return {
        "paths": out,
        "busy_ms": merged_busy(iv) * 1e-3 / units,
        "idle_ms": idle_total * 1e-3 / units,
        "coverage": {
            "device": sum(r["device_ms"] for r in inside.values()) / dev_ms if dev_ms else 0.0,
            "launches": (sum(r["launches"] for r in inside.values()) / launches
                         if launches else 0.0)},
    }


def by_name(paths: Dict[str, Dict]) -> Dict[str, Dict]:
    """Per-path rows summed by each path's innermost name."""
    out = collections.defaultdict(lambda: collections.Counter())
    for path, row in paths.items():
        out[path.rsplit("/", 1)[-1]].update(row)
    return {n: dict(r) for n, r in out.items()}


def layer_device(paths: Dict[str, Dict]) -> Dict[str, Dict]:
    """Per layer of :data:`LAYERS`: the ``device_ms``, ``launches`` and
    ``idle_ms`` of every path that runs through one of its spans."""
    out = {}
    for layer, names in LAYERS.items():
        rows = [r for p, r in paths.items() if set(p.split("/")) & set(names)]
        out[layer] = {k: sum(r[k] for r in rows) for k in ("device_ms", "launches", "idle_ms")}
    return out


def host_split(rec) -> Dict:
    """A recording of units (``Recording.unit``) -> per span name the median
    unit's ``calls``, ``incl_ms`` and ``self_ms``; per layer its inclusive
    ms; the median unit wall, and the median share of a unit's wall that
    its top-level spans cover."""
    table = rec.summary()
    walls = rec.unit_walls_ms()
    shares = [t / w for t, w in zip(rec.top_level_ms(), walls) if w > 0]
    return {
        "names": table,
        "layers": {layer: sum(table.get(n, {}).get("incl_ms", 0.0) for n in names)
                   for layer, names in LAYERS.items()},
        "unit_wall_ms": statistics.median(walls) if walls else None,
        "top_level_share": statistics.median(shares) if shares else None,
    }
