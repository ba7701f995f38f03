"""The port's open-loop eval runner (``hipad_torch.eval.runner``) against
the JAX package's, on ``tests/test_eval_runner.py``'s setup: the same two
80-frame routes of synthetic infos, the same tiny config at the dataset's
shapes, JAX's initial weights carried to the port by ``weights.from_jax``,
fp32 on the CPU.

Tolerances. Port against JAX: the same fp32 model summed in other orders
(convolutions, attention, sampler; ``test_torch_port_model.py``'s bound),
so each float of a per-frame record within RTOL of the largest magnitude
of its reference array plus ATOL, and each summary metric within rel 1e-4,
abs 1e-5. The picks (class names, labels) must be equal; a pick that
differs is reported with the score gap that decided it. The port alone:
batched against streaming with ``test_eval_runner.py``'s rel 1e-4, abs
1e-5 (a bs=2 forward sums in other orders), two ranks against one with its
rel 1e-6, abs 1e-8 (the same forwards).
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from hipad_torch.configs import model as tcfg
from hipad_torch.data.bench2drive import Bench2DriveDataset as TDataset
from hipad_torch.eval import runner as trun
from hipad_torch.eval.motion import evaluate_motion
from hipad_torch.models.detector import HiPAD
from hipad_torch.weights import from_jax, init_random
from hipad_tpu.configs import model as jcfg
from hipad_tpu.data.bench2drive import Bench2DriveDataset as JDataset
from hipad_tpu.eval import runner as jrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import data_converter as dc  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
FRAMES = 24  # three sequences of 8 (split_group interleaving), both routes
TASKS = dict(eval_det=True, eval_map=True, eval_motion=True)
AUG_CONF = {"resize_lim": (0.4, 0.4), "final_dim": (64, 96), "bot_pct_lim": (0.0, 0.0),
            "rot_lim": (0.0, 0.0), "H": 160, "W": 240, "rand_flip": False,
            "rot3d_range": (0.0, 0.0)}


def _cfg_kwargs(m):
    return dict(num_cams=6, input_size=(64, 96), ego_fut_ts=6, fut_ts=6,
                plan_kps=m.PointKeypointSpec(6, 2, (0.0, 0.5), m.GROUND_HEIGHT),
                plan_anchor_types=(("temp", "2hz"), ("spat", "2m"), ("speed", "2hz", (0.0, 3.0)),
                                   ("speed", "2hz", (3.0, 999.0))),
                plan_anchor_refer=("spat", "2m"), plan_speed_refer=("temp", "2hz"))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from test_dataset_roundtrip import _raw_anno

    frames = []
    for route in range(2):
        last = {}
        for i in range(80):
            frames.append(dc.convert_frame(_raw_anno(i / 10.0, 0.5 * i),
                                           f"v1/Town01_route{route}", i, "Town01", last))
    pkl = tmp_path_factory.mktemp("eval_runner") / "val.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(frames, f)
    cfg = tcfg.tiny(**_cfg_kwargs(tcfg))
    dataset = TDataset(ann_file=str(pkl), map_file=None, test_mode=True,
                       plan_anchor_types=cfg.plan_anchor_types, data_aug_conf=AUG_CONF)
    return str(pkl), cfg, dataset


@pytest.fixture(scope="module")
def port_model(split):
    return init_random(HiPAD(split[1], device="cpu"), 0)


@pytest.fixture(scope="module")
def against_jax(split):
    """JAX's runner over FRAMES frames with its initial weights -> (its
    records, its summary, the port's model on those weights)."""
    import jax.numpy as jnp

    from hipad_tpu.data import synthetic
    from hipad_tpu.models.detector import HiPAD as JHiPAD
    from hipad_tpu.train.train_step import META_KEYS

    pkl, _, _ = split
    cfg = jcfg.tiny(**_cfg_kwargs(jcfg))
    dataset = JDataset(ann_file=pkl, map_file=None, test_mode=True,
                       plan_anchor_types=cfg.plan_anchor_types, data_aug_conf=AUG_CONF)
    model = JHiPAD(cfg)
    batch = synthetic.make_batch(cfg, 1)
    variables = jax.jit(lambda r: model.init(
        {"params": r}, jnp.asarray(batch["images"]), {k: jnp.asarray(batch[k]) for k in META_KEYS},
        train=False))(jax.random.PRNGKey(0))
    records = {}
    summarize = jrun._summarize

    def keep(acc):
        records.update(acc)
        return summarize(acc)

    jrun._summarize = keep  # the runner returns only the summary
    try:
        summary = jrun.run_openloop_eval(cfg, variables, dataset, max_frames=FRAMES, **TASKS)
    finally:
        jrun._summarize = summarize
    port = HiPAD(split[1], device="cpu")
    missing = port.load_state_dict(from_jax(jax.tree_util.tree_map(np.asarray, variables)),
                                   strict=False)
    # an eval-mode init builds no depth head: the port's keeps its own weights
    assert not missing.unexpected_keys
    assert {k.split(".")[0] for k in missing.missing_keys} == {"depth_net"}
    return records, summary, port


def _entries(value):
    """A record entry as {name: numpy array}."""
    return {k: np.asarray(v) for k, v in value.items()}


def _pick_gap(ref, got, key):
    """Where the picks of ``key`` differ: the first position, both picks
    and the scores around it in the reference (the gap that decided)."""
    i = int(np.flatnonzero(ref[key] != got[key])[0])
    s = ref.get("scores", np.zeros(0))
    return (f"{key} differ first at {i}: {ref[key][i]} against {got[key][i]}; reference "
            f"scores there {s[max(i - 1, 0):i + 2]}, port's "
            f"{got.get('scores', np.zeros(0))[max(i - 1, 0):i + 2]}")


def _records_close(got, ref, rtol, atol):
    """Every per-frame record of ``ref`` in ``got``: the same frames, equal
    picks, floats within rtol * max|ref array| + atol."""
    for key, ref_list in ref.items():
        if not isinstance(ref_list, list) or key in ("frames", "load_s", "forward_s"):
            continue
        r = sorted(ref_list, key=lambda t: t[0])
        g = sorted(got[key], key=lambda t: t[0])
        assert [i for i, _ in g] == [i for i, _ in r], key
        for (idx, gv), (_, rv) in zip(g, r):
            gv, rv = _entries(gv), _entries(rv)
            assert gv.keys() == rv.keys(), (key, idx)
            for name, b in rv.items():
                a = gv[name]
                assert a.shape == b.shape, (key, idx, name, a.shape, b.shape)
                if b.dtype.kind in "fc" and b.dtype != bool:
                    tol = rtol * (np.abs(b).max() if b.size else 0.0) + atol
                    err = np.abs(a.astype(np.float64) - b).max() if b.size else 0.0
                    assert err <= tol, (key, idx, name, err, tol)
                else:
                    assert np.array_equal(a, b), (key, idx, _pick_gap(rv, gv, name))


def _flat(summary):
    return {f"{k}/{m}": float(x) for k, d in summary.items() for m, x in d.items()}


def _summaries_close(got, ref, rel, abs_):
    fg, fr = _flat(got), _flat(ref)
    assert set(fg) == set(fr), set(fg) ^ set(fr)
    for k in fr:
        assert fg[k] == pytest.approx(fr[k], rel=rel, abs=abs_), k


def test_records_match_jax(split, against_jax):
    """Per-frame records first: every float of every frame's planning,
    detection, map and motion record, and equal picks."""
    records, _, port = against_jax
    got = trun.collect_records(port, split[2], max_frames=FRAMES, **TASKS)
    assert sorted(got["frames"]) == list(range(FRAMES))
    _records_close(got, records, RTOL, ATOL)


def test_summary_matches_jax(split, against_jax):
    """Then the summaries: JAX's every metric, and the port's motion match
    counts beside them (the only keys JAX lacks)."""
    _, summary, port = against_jax
    got = trun.run_openloop_eval(port, split[2], max_frames=FRAMES, **TASKS)
    extra = set(_flat(got)) - set(_flat(summary))
    assert extra == {"motion/car_matches", "motion/pedestrian_matches"}, extra
    for key in extra:
        del got["motion"][key.split("/")[1]]
    _summaries_close(got, summary, 1e-4, 1e-5)
    assert set(summary) == {"planning", "detection", "map", "motion"}


def test_batched_matches_streaming(split, port_model):
    """``batch_slots=2`` (first frames at bs=1 scattered into their slot,
    the rest at bs=2 under the live mask) gives the streaming records."""
    _, _, dataset = split
    stream = trun.collect_records(port_model, dataset, max_frames=FRAMES, **TASKS)
    batched = trun.collect_records(port_model, dataset, max_frames=FRAMES, batch_slots=2,
                                   num_workers=2, **TASKS)
    assert sorted(batched["frames"]) == sorted(stream["frames"]) == list(range(FRAMES))
    _records_close(batched, stream, 1e-4, 1e-5)
    _summaries_close(trun.summarize(batched), trun.summarize(stream), 1e-4, 1e-5)


def test_multirank_matches_single(split, port_model, tmp_path):
    """Two ranks, one after the other in this process, through one gather
    dir (the gather is files, no collective): rank 1 returns None, rank 0
    the single-rank summary."""
    _, _, dataset = split
    single = trun.run_openloop_eval(port_model, dataset, max_frames=FRAMES, **TASKS)
    gd = str(tmp_path / "gather")
    assert trun.run_openloop_eval(port_model, dataset, max_frames=FRAMES, rank=1, world=2,
                                  gather_dir=gd, **TASKS) is None
    merged = trun.run_openloop_eval(port_model, dataset, max_frames=FRAMES, rank=0, world=2,
                                    gather_dir=gd, **TASKS)
    _summaries_close(merged, single, 1e-6, 1e-8)
    with pytest.raises(ValueError, match="gather_dir"):
        trun.run_openloop_eval(port_model, dataset, max_frames=2, rank=0, world=2)


def test_motion_matches_count_what_min_ade_averages_over():
    """A car matched with a valid future counts; one matched with none, a
    prediction 3 m away (past MATCH_DIST) and one under the score
    threshold do not. With no match minADE reads 0.0, the count says why."""
    fut = np.zeros((4, 6, 2))
    masks = np.array([[1] * 6, [0] * 6, [1] * 6, [1] * 6], np.float32)
    gt = {"boxes": np.array([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0], [30.0, 0.0]]),
          "names": np.array(["car"] * 4), "fut_trajs": fut, "fut_masks": masks}
    pred = {"boxes": np.array([[0.5, 0.0], [10.0, 0.5], [23.0, 0.0], [30.0, 0.0]]),
            "names": np.array(["car"] * 4), "scores": np.array([0.9, 0.8, 0.7, 0.1]),
            "trajs": np.ones((4, 2, 6, 2)), "traj_scores": np.ones((4, 2))}
    assert trun.motion_matches([gt], [pred]) == {"car_matches": 1}
    res = evaluate_motion([gt], [pred])
    assert res["car_minADE"] == pytest.approx(np.sqrt(2))
    none = dict(pred, scores=np.zeros(4))
    assert trun.motion_matches([gt], [none]) == {"car_matches": 0}
    assert evaluate_motion([gt], [none])["car_minADE"] == 0.0
