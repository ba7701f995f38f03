"""The port's spans (``hipad_torch/utils/spans.py``) on the CPU at ``tiny()``:
off, a frame records nothing and computes what it computes under
``recording()``, bit for bit; on, a frame opens the span tree that the
layers' metrics read, and under ``torch.profiler`` each span lies in the
trace as one ``hipad::`` range with the same nesting; self time is the
inclusive time less the children's."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hipad_torch import postprocess
from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.utils import spans
from hipad_torch.weights import init_random


def _trace_spans(prof, tmp_path):
    """The trace's ``hipad::`` ranges in opening order: (name, index of the
    enclosing range or -1)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(spans.PREFIX)]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for i, e in enumerate(events):
        while stack and events[stack[-1]]["ts"] + events[stack[-1]]["dur"] <= e["ts"]:
            stack.pop()
        out.append((e["name"][len(spans.PREFIX):], stack[-1] if stack else -1))
        stack.append(i)
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A warm frame (banks from a cold one) run twice from the same banks,
    each under a CPU profiler: spans off, then under ``recording()``."""
    cfg = tiny()
    model = init_random(HiPAD(cfg, device="cpu"), 0)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1), "cpu")
    with torch.no_grad():
        _, banks = model(images, metas)

    def frame():
        with torch.no_grad():
            out, new_banks = model(images, metas, banks)
            dec = postprocess.post_process_arrays(cfg, out, metas["gt_ego_fut_cmd"])
        return out, new_banks, postprocess.to_result_dicts(dec)

    tmp = tmp_path_factory.mktemp("spans")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = frame()
    off_trace = _trace_spans(prof, tmp)
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as rec:
        with rec.unit():
            on = frame()
    return dict(cfg=cfg, off=off, on=on, off_trace=off_trace, rec=rec,
                on_trace=_trace_spans(prof, tmp))


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _leaves(y)]
    if hasattr(x, "__dataclass_fields__"):
        return [v for k in sorted(x.__dataclass_fields__) for v in _leaves(getattr(x, k))]
    return [x]


def test_off_records_nothing_and_on_changes_nothing(frames):
    assert frames["off_trace"] == [] and spans._recording is None
    off, on = _leaves(frames["off"]), _leaves(frames["on"])
    assert len(off) == len(on) > 20
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype and (a == b).all()


def test_frame_opens_the_span_tree(frames):
    cfg, rec = frames["cfg"], frames["rec"]
    top = [n for n, p in zip(rec.name, rec.parent) if p < 0]
    assert top == ["forward", "postprocess", "to_host"]
    kids = {}
    for i, p in enumerate(rec.parent):
        kids.setdefault(p, []).append(i)
    fwd = rec.name.index("forward")
    assert [rec.name[i] for i in kids[fwd]] == ["backbone", "decoder"]
    dec = rec.name.index("decoder")
    assert [rec.name[i] for i in kids[dec]] == (
        ["decoder.init"] + ["decoder." + op for op in cfg.operation_order]
        + ["decoder.bank_cache"])
    n_deform = cfg.operation_order.count("deformable")
    for i, name in enumerate(rec.name):
        if name.startswith("sampler."):
            assert rec.name[rec.parent[i]] == "sampler"
        if name == "sampler":
            assert rec.name[rec.parent[i]].startswith("deformable.")
        if name.startswith("deformable."):
            assert rec.name[rec.parent[i]] == "decoder.deformable"
    assert rec.name.count("deformable.det") == n_deform
    assert rec.name.count("sampler") == n_deform * len(cfg.query_select)
    assert rec.name.count("sampler.coarse") == rec.name.count("sampler.patch") == \
        rec.name.count("sampler")
    post = rec.name.index("postprocess")
    assert {rec.name[i] for i in kids[post]} >= {"post.det", "post.map", "post.plan"}
    assert all(e >= s for s, e in zip(rec.start_ns, rec.end_ns))
    assert rec.summary()["decoder.deformable"]["calls"] == n_deform
    (wall,) = rec.unit_walls_ms()
    assert 0 < rec.top_level_ms()[0] <= wall


def test_profiler_trace_holds_each_span_once(frames):
    rec = frames["rec"]
    assert frames["on_trace"] == list(zip(rec.name, rec.parent))


def test_self_time_and_unit_medians():
    """A hand-built nesting: two units of a(b, c(d)) and one of a alone."""
    rec = spans.Recording()
    rows = [  # name, parent, start, end (ns)
        ("a", -1, 0, 100), ("b", 0, 10, 30), ("c", 0, 40, 90), ("d", 2, 50, 60),
        ("a", -1, 200, 260), ("b", 4, 200, 210), ("c", 4, 220, 250), ("d", 6, 230, 240),
        ("a", -1, 300, 310)]
    for name, parent, s, e in rows:
        rec.name.append(name)
        rec.parent.append(parent)
        rec.start_ns.append(s * 10 ** 6)
        rec.end_ns.append(e * 10 ** 6)
    assert rec.self_ns() == [v * 10 ** 6 for v in (30, 20, 40, 10, 20, 10, 20, 10, 10)]
    assert rec.summary()["a"] == {"calls": 3, "incl_ms": 170.0, "self_ms": 60.0}
    rec.units = [(0, 4, 0, 120 * 10 ** 6), (4, 8, 200 * 10 ** 6, 270 * 10 ** 6),
                 (8, 9, 300 * 10 ** 6, 320 * 10 ** 6)]
    s = rec.summary()
    assert s["a"] == {"calls": 1, "incl_ms": 60.0, "self_ms": 20.0}
    assert s["c"] == {"calls": 1, "incl_ms": 30.0, "self_ms": 20.0}
    assert rec.unit_walls_ms() == [120.0, 70.0, 20.0]
    assert rec.top_level_ms() == [100.0, 60.0, 10.0]


def test_other_threads_and_nesting_recordings():
    with spans.recording() as rec:
        t = threading.Thread(target=lambda: spans.span("elsewhere").__enter__())
        t.start()
        t.join(10)
        assert not t.is_alive()
        with spans.span("here"):
            pass
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert rec.name == ["here"] and rec.parent == [-1]
