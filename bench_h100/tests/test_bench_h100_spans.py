"""The reader of the program's spans (``harness/spans.py``) on a hand-made
Chrome trace, and the split tool (``span_split.py``) end to end on the CPU."""

import pytest

from bench_h100.harness import spans as read_spans
from bench_h100.harness.spans import OUTSIDE

MAIN, OTHER, STREAM = 1, 2, 7


def _span(name, ts, end, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": "hipad::" + name, "ts": ts,
            "dur": end - ts, "tid": tid}


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, end):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": end - ts,
            "tid": STREAM, "args": {"correlation": corr}}


EVENTS = [
    # forward(decoder(decoder.gnn)) on the main thread, then to_host
    _span("forward", 0, 100), _span("decoder", 10, 90), _span("decoder.gnn", 20, 40),
    _span("to_host", 120, 150),
    _launch(1, 25),              # inside decoder.gnn (and decoder, forward): the innermost
    _launch(2, 50),              # inside decoder alone
    _launch(3, 110),             # inside no span
    _launch(4, 30, tid=OTHER),   # inside decoder.gnn's time, but on another thread
    _launch(5, 60, name="cudaStreamSynchronize"),  # launches nothing
    _kernel(1, 30, 40), _kernel(2, 55, 75), _kernel(4, 80, 85), _kernel(3, 112, 115),
]
GNN, DEC = "forward/decoder/decoder.gnn", "forward/decoder"


def test_launches_go_to_the_innermost_span_on_their_thread():
    got = read_spans.read_events(EVENTS, units=1)["paths"]
    assert got[GNN]["launches"] == 1 and got[GNN]["device_ms"] == pytest.approx(0.010)
    assert got[DEC]["launches"] == 1 and got[DEC]["device_ms"] == pytest.approx(0.020)
    assert got[OUTSIDE]["launches"] == 2 and got[OUTSIDE]["device_ms"] == pytest.approx(0.008)
    assert "forward" not in got or got["forward"]["launches"] == 0
    half = read_spans.read_events(EVENTS, units=2)
    assert half["paths"][DEC]["device_ms"] == pytest.approx(0.010)
    assert half["coverage"] == pytest.approx({"device": 30 / 38, "launches": 0.5})


def test_idle_is_split_by_the_innermost_span_open_on_the_host():
    """Busy [30,40] [55,75] [80,85] [112,115] in a window [0,150]: the idle
    [85,112] goes 5 to decoder, 10 to forward and 12 to no span."""
    res = read_spans.read_events(EVENTS, units=1)
    idle = {p: r["idle_ms"] * 1e3 for p, r in res["paths"].items()}
    assert idle == pytest.approx({"forward": 20, DEC: 35, GNN: 10, "to_host": 30,
                                  OUTSIDE: 17})
    assert res["idle_ms"] * 1e3 == pytest.approx(112)
    assert res["busy_ms"] * 1e3 == pytest.approx(38)


def test_segments_names_and_layers():
    segs = read_spans.innermost_segments(
        [(0, 100, "a"), (10, 90, "a/b"), (20, 40, "a/b/c"), (120, 150, "d")])
    assert segs == [(0, 10, "a"), (10, 20, "a/b"), (20, 40, "a/b/c"), (40, 90, "a/b"),
                    (90, 100, "a"), (120, 150, "d")]
    paths = read_spans.read_events(EVENTS, units=1)["paths"]
    assert read_spans.by_name(paths)["decoder.gnn"]["launches"] == 1
    layers = read_spans.layer_device(paths)
    assert layers["decoder"] == pytest.approx({"device_ms": 0.030, "launches": 2,
                                               "idle_ms": 0.045})
    assert layers["postprocess"] == pytest.approx({"device_ms": 0, "launches": 0,
                                                   "idle_ms": 0.030})


def test_split_runs_on_the_cpu(tiny_root):
    """The split tool's steps at tiny() on the CPU (no waits to count
    there): spans change no output, and every layer has host time."""
    from bench_h100 import span_split
    from bench_h100.harness import cells, spec

    drv = cells.driver(spec.load_cell("tiny.frame", tiny_root), 2 ** 31 + 977, "cpu")
    drv.setup()
    out = span_split.split(drv, units=2, profiled=1, sync=1, pairs=1, window=0.05)
    assert out["identical"] == {"off_off": True, "off_on": True}
    assert len(out["on_cost"]["cost_ms"]) == 1
    layers = out["layers"]
    assert sorted(layers) == sorted(f"{layer}_{k}.frame" for layer in read_spans.LAYERS
                                    for k in ("host_ms", "device_ms", "launches"))
    host = [layers[f"{layer}_host_ms.frame"] for layer in read_spans.LAYERS]
    assert all(v > 0 for v in host) and sum(host) <= out["host"]["unit_wall_ms"]
    assert {"forward", "backbone", "decoder", "decoder.init", "decoder.deformable",
            "deformable.det", "sampler", "sampler.coarse", "sampler.patch",
            "decoder.bank_cache", "postprocess", "post.det", "post.plan",
            "to_host"} <= set(out["names"])
