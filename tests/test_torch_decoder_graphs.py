"""The decoder's op runs and their CUDA graphs (``hipad_torch/models/
decoder_graphs.py``) on the CPU: the runs cut at ``deformable`` cover the op
program once, in order; the rule that replays them engages only for a warm
no-grad eval frame on the card; the state's flattening round trip is the
identity; a stream of frames gives what the ops run one by one give. The
cache's own logic (keys, the first sight eager, capture, input copies,
outputs handed out past the next replay) runs here with a stand-in for the
CUDA graph that keeps the graph's semantics: outputs at fixed tensors,
rewritten from the graph's input buffers at each replay. The graphs
themselves run on the card (``chip_smoke.py --graphs``)."""

import itertools

import pytest
import torch

from hipad_torch.configs.model import (SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER, stage2,
                                       stage2_serving_det, tiny)
from hipad_torch.data import synthetic
from hipad_torch.models import decoder_graphs
from hipad_torch.models.decoder import DecoderState
from hipad_torch.models.decoder_graphs import engages, flatten, op_units, unflatten
from hipad_torch.models.detector import HiPAD, batch_to_torch
from hipad_torch.weights import init_random

CONFIGS = {
    "plain": {},
    "det_prune": dict(sampler_point_frac=0.5, with_topk_det=True, topk_det_list=(12, 6, 6),
                      operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2),
    "mode_prune": dict(with_topk_mode=True, topk_mode_list=(3, 2), num_temp_plan_mode=2),
    "masks": dict(with_distance_attn_mask=True, with_velocity_attn_mask=True,
                  with_deform_plan_points=True),
    "points": dict(with_concat_map_points=True, with_concat_plan_points=True),
}


def _runs(order):
    return [(lo, hi) for lo, hi in op_units(order) if order[lo] != "deformable"]


@pytest.mark.parametrize("make", [tiny, stage2, stage2_serving_det],
                         ids=["tiny", "stage2", "stage2_serving_det"])
def test_runs_cover_the_op_program_once_in_order(make):
    order = make().operation_order
    units = op_units(order)
    assert [i for lo, hi in units for i in range(lo, hi)] == list(range(len(order)))
    for (lo, hi), (lo2, _) in zip(units, units[1:]):
        assert hi == lo2
        # maximal: two runs never follow each other
        assert "deformable" in (order[lo], order[lo2])
    for lo, hi in units:
        assert "deformable" not in order[lo:hi] or hi - lo == 1
    runs = [" ".join(order[lo:hi]) for lo, hi in _runs(order)]
    assert len(runs) == order.count("deformable") + 1
    if make is not tiny:
        mid = "concat ffn norm split refine concat temp_gnn gnn inter_gnn norm split"
        assert runs == (["concat gnn inter_gnn norm split"] + [mid] * 5
                        + ["concat ffn norm split refine"])


@pytest.mark.parametrize("device,training,grad,warm",
                         list(itertools.product(("cpu", "cuda"), (False, True), (False, True),
                                                (False, True))))
def test_replay_engages_only_for_a_warm_no_grad_eval_frame_on_the_card(device, training, grad,
                                                                        warm):
    want = device == "cuda" and not training and not grad and warm
    assert engages(torch.device(device), training, grad, warm) is want


def _model(cfg):
    return init_random(HiPAD(cfg, device="cpu"), 0)


def _frames(cfg, n, seed=0):
    """``n`` frames of one scene, 0.5 s apart, each with other images."""
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=seed), "cpu")
    return [(images + 0.1 * t, dict(metas, timestamp=metas["timestamp"] + 0.5 * t))
            for t in range(n)]


@pytest.fixture(scope="module")
def plain():
    cfg = tiny()
    model = _model(cfg)
    frames = _frames(cfg, 3)
    with torch.no_grad():
        _, banks = model(*frames[0])
    return cfg, model, frames, banks


def _same(a, b, strides=True) -> bool:
    """Same structure and Python values, tensors equal bit for bit (and laid
    out alike)."""
    sa, la = flatten(a)
    sb, lb = flatten(b)
    return sa == sb and all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                            and (not strides or x.stride() == y.stride())
                            for x, y in zip(la, lb))


def test_state_flattening_round_trip_is_the_identity(plain):
    cfg, model, frames, banks = plain
    images, metas = frames[1]
    with torch.no_grad():
        fmaps = model.backbone(images)
        for b in (None, banks):
            st = model.decoder._init_state(fmaps, metas, b)
            if b is not None:  # through the first run: joint tensors, sections
                lo, hi = _runs(cfg.operation_order)[0]
                model.decoder._run_ops(lo, hi, st)
            spec, leaves = flatten(st)
            hash(spec)
            back = unflatten(spec, leaves)
            assert isinstance(back, DecoderState) and back is not st
            spec2, leaves2 = flatten(back)
            assert spec2 == spec and len(leaves2) == len(leaves) > 10
            assert all(x is y for x, y in zip(leaves, leaves2))
            for f in ("bs", "device", "has_temp", "det_live", "refine_i", "deform_i",
                      "cur_sections", "temp_sections"):
                assert getattr(back, f) == getattr(st, f)
            assert back.feat.keys() == st.feat.keys()
            assert (back.det_bank_state is None) == (b is None)
            assert [len(v) for v in back.out["det"].values()] == \
                [len(v) for v in st.out["det"].values()]
    spec, leaves = flatten(banks)
    back = unflatten(spec, leaves)
    assert type(back) is type(banks) and _same(back, banks)
    assert all(x is y for x, y in zip(flatten(back)[1], leaves))


def test_stream_gives_what_the_ops_one_by_one_give(plain):
    """Three frames from the cold one's banks, through the forward (runs)
    and through ``forward_eager`` (ops one at a time), each frame from the
    same banks: outputs and banks equal bit for bit; on the CPU every run
    goes eager and is counted so."""
    cfg, model, frames, banks = plain
    dec = model.decoder
    n_runs = len(_runs(cfg.operation_order))
    before = dict(dec.graphs.counts)
    with torch.no_grad():
        for images, metas in frames:
            fmaps = model.backbone(images)
            got = dec(fmaps, metas, banks)
            want = dec.forward_eager(fmaps, metas, banks)
            assert _same(got, want)
            banks = got[1]
    assert dec.graphs.counts == dict(before, eager=before["eager"] + 3 * n_runs)


class CopyingCache(decoder_graphs.GraphCache):
    """The graph cache with a stand-in for the CUDA graph: the capture runs
    the run once and keeps its outputs; a replay runs it again on the
    graph's input buffers and writes the results into those same output
    tensors, as a graph's replay rewrites its static outputs."""

    def capture(self, body):
        spec, outputs = body()

        def replay():
            _, new = body()
            for old, fresh in zip(outputs, new):
                if old is not fresh:
                    old.copy_(fresh)

        return replay, (spec, outputs)


def _snapshot(tree):
    spec, leaves = flatten(tree)
    return unflatten(spec, [x.clone() for x in leaves])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replayed_stream_equals_eager_and_hands_out_lasting_tensors(name, monkeypatch):
    """Five frames (cold, then warm) with the stand-in graphs engaged on warm
    frames: each frame's outputs and banks equal ``forward_eager``'s from
    the same banks bit for bit; the counts read every run eager on the cold
    frame and on the first warm one, captured on the second, replayed after;
    every frame's outputs and banks, held, are unchanged after the later
    frames, and none lies in a graph's memory; a reload of the weights drops
    the graphs."""
    cfg = tiny(**CONFIGS[name])
    model = _model(cfg)
    dec = model.decoder
    dec.graphs = cache = CopyingCache()
    monkeypatch.setattr(decoder_graphs, "engages",
                        lambda device, training, grad, warm: warm and not training and not grad)
    n_runs = len(_runs(cfg.operation_order))
    banks, held = None, []
    with torch.no_grad():
        for t, (images, metas) in enumerate(_frames(cfg, 5, seed=1)):
            fmaps = model.backbone(images)
            want = dec.forward_eager(fmaps, metas, banks)
            got = dec(fmaps, metas, banks)
            assert _same(got, want), f"frame {t}"
            held.append((got, _snapshot(got)))
            banks = got[1]
    assert cache.counts == {"captured": n_runs, "replayed": 2 * n_runs, "eager": 2 * n_runs}
    assert len(cache._graphs) == n_runs and cache._owned
    for t, (live, snap) in enumerate(held):
        assert _same(live, snap, strides=False), f"frame {t}'s outputs or banks changed after it"
        assert not {decoder_graphs._storage(x) for x in flatten(live)[1]} & cache._owned

    model.load_state_dict(model.state_dict())
    assert not cache._graphs
    with torch.no_grad():
        images, metas = _frames(cfg, 6, seed=1)[5]
        dec(model.backbone(images), metas, banks)
    assert cache.counts["eager"] == 3 * n_runs


def test_an_input_from_elsewhere_than_at_the_capture_goes_eager():
    """A run whose input lay in a parameter at the capture and lies elsewhere
    now is run eagerly (a graph never writes into a parameter)."""
    cache = CopyingCache()
    w = torch.nn.Parameter(torch.ones(4))

    def fn(st):
        return {"y": st["x"] * 2 + st["b"]}

    def run(x, b):
        return cache.run((0, 1), fn, {"x": x, "b": b}, True, lambda: [w])

    b = torch.zeros(4)
    for _ in range(3):  # eager, captured, replayed
        out = run(w.detach(), b + 1)
        assert torch.equal(out["y"], torch.full((4,), 3.0))
    assert cache.counts == {"captured": 1, "replayed": 1, "eager": 1}
    out = run(torch.full((4,), 5.0), b)  # same key, not the parameter
    assert torch.equal(out["y"], torch.full((4,), 10.0)) and cache.counts["eager"] == 2
    out = run(w.detach(), b + 2)  # the parameter again: replayed, the other input copied
    assert torch.equal(out["y"], torch.full((4,), 4.0)) and cache.counts["replayed"] == 2
