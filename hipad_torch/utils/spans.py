"""Named spans at the program's layer boundaries, off unless recorded.

    with span("backbone"):          # a context manager ...
        feature_maps = self.backbone(images)

    @span("sampler.coarse")         # ... or a decorator
    def coarse_sample(...): ...

    with recording() as rec:        # spans on for the body, on this thread
        for frame in frames:
            with rec.unit():        # one unit of work (a frame, a step)
                model(...)
    rec.summary()                   # {name: {"calls", "incl_ms", "self_ms"}}

Off, which is the default, entering a span reads one module flag and does
nothing else. Under :func:`recording` each span keeps its name, the index of
its parent span and its start and end (``time.perf_counter_ns``), in memory.
While a profiler is on, a recorded span also opens
``torch.profiler.record_function("hipad::" + name)``, so that it lies in the
profiler's trace as a ``user_annotation`` on the clock of the device's
kernels and copies; with no profiler that range would cost some 10 us a span
and record nothing, so it is not opened. A span never touches the device (no
synchronize, no event, no tensor read), so it cannot add a wait for the host
or change an output, and a CUDA-graph capture can hold it.

Names are dotted lower-case words (``decoder.deformable``, ``sampler.patch``);
the sites and what each covers are listed in ``PERF.md`` (Layers).
"""

from __future__ import annotations

import contextlib
import functools
import statistics
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "hipad::"  # of each span's profiler range

_recording: Optional["Recording"] = None  # the one flag a span reads when off


class span:
    """A named span: ``with span(name):`` or ``@span(name)``. Holds only its
    name, so one object may be entered many times and from nested calls."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _recording
        if rec is not None:
            rec._open(self.name)

    def __exit__(self, *exc):
        rec = _recording
        if rec is not None:
            rec._close()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _recording is None:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return wrapped


class Recording:
    """The spans recorded on one thread: parallel lists indexed by span, in
    the order the spans opened; ``parent`` is -1 for a top-level span."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.name: List[str] = []
        self.parent: List[int] = []
        self.start_ns: List[int] = []
        self.end_ns: List[int] = []
        # each marked unit: (index of its first span, of the first after it,
        # start ns, end ns)
        self.units: List[tuple] = []
        self._stack: List[tuple] = []  # (span index, its profiler range)

    def _open(self, name: str):
        if threading.get_ident() != self.thread:
            return
        i = len(self.name)
        rf = None
        if _profiler._is_profiler_enabled:  # torch's own flag for cheap checks
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
        self.name.append(name)
        self.parent.append(self._stack[-1][0] if self._stack else -1)
        self.end_ns.append(-1)
        self._stack.append((i, rf))
        self.start_ns.append(time.perf_counter_ns())

    def _close(self):
        t = time.perf_counter_ns()
        if threading.get_ident() != self.thread:
            return
        i, rf = self._stack.pop()
        self.end_ns[i] = t
        if rf is not None:
            rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def unit(self) -> Iterator[None]:
        """Marks its body as one unit of work."""
        first, t0 = len(self.name), time.perf_counter_ns()
        try:
            yield
        finally:
            self.units.append((first, len(self.name), t0, time.perf_counter_ns()))

    def self_ns(self) -> List[int]:
        """Each span's duration less the part its child spans cover (children
        of one span run one after another on its thread, so they do not
        overlap)."""
        own = [e - s for s, e in zip(self.start_ns, self.end_ns)]
        for i, p in enumerate(self.parent):
            if p >= 0:
                own[p] -= self.end_ns[i] - self.start_ns[i]
        return own

    def _sums(self, lo: int, hi: int, own: List[int]) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {}
        for i in range(lo, hi):
            row = out.setdefault(self.name[i], [0, 0.0, 0.0])
            row[0] += 1
            row[1] += (self.end_ns[i] - self.start_ns[i]) * 1e-6
            row[2] += own[i] * 1e-6
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per name: ``calls``, ``incl_ms`` (inclusive) and ``self_ms``. With
        units marked, each is the median over the units of the unit's sum (0
        in a unit that did not open the name); else the sum over every span."""
        own = self.self_ns()
        if not self.units:
            return {n: dict(zip(("calls", "incl_ms", "self_ms"), row))
                    for n, row in self._sums(0, len(self.name), own).items()}
        per_unit = [self._sums(lo, hi, own) for lo, hi, _, _ in self.units]
        names = {n: None for sums in per_unit for n in sums}
        return {n: {key: statistics.median(s.get(n, [0, 0.0, 0.0])[k] for s in per_unit)
                    for k, key in enumerate(("calls", "incl_ms", "self_ms"))}
                for n in names}

    def unit_walls_ms(self) -> List[float]:
        return [(t1 - t0) * 1e-6 for _, _, t0, t1 in self.units]

    def top_level_ms(self) -> List[float]:
        """Each unit's time inside its top-level spans."""
        return [sum(self.end_ns[i] - self.start_ns[i] for i in range(lo, hi)
                    if self.parent[i] < 0) * 1e-6 for lo, hi, _, _ in self.units]


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Spans on for the body, recorded from the calling thread; the spans of
    other threads are not kept. Recordings do not nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
