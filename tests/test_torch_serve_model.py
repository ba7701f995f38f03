"""The serving knobs of the port against the JAX package on the CPU, at
``tiny()`` widths, fp32: the deformable op's keypoint top-k
(``sampler_point_frac``), and two-frame ``HiPAD`` episodes with det-query
pruning (``with_topk_det``) and plan-mode pruning (``with_topk_mode``).

Every knob makes selections (keypoints by weight mass, the first frame's
confidence sort, the banks' top-k, the plan modes). Both packages break ties
towards the lower index, so a tie (every keypoint outside all cameras has
mass exactly 0) selects the same rows on both sides.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.configs.model import SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER, tiny
from hipad_torch.data import synthetic
from hipad_torch.models import deformable as tdef
from hipad_torch.models import keypoints as tkps
from hipad_torch.models.detector import META_KEYS, HiPAD, batch_to_torch
from hipad_tpu.models import deformable as jdef
from hipad_tpu.models import keypoints as jkps
from hipad_tpu.models.detector import HiPAD as JHiPAD
from test_torch_port_model import _bank_leaves, _leaves, _port
from test_torch_port_modules import _box_anchors, _close, _feature_maps, _j, _projection, _t
from test_torch_port_modules import _port as _port_module
from test_torch_port_modules import _vars, BS, C, CFG

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# As the stage-2 episode (test_torch_port_model.py): ten-odd layers of the
# same fp32 arithmetic summed in other orders.
RTOL, ATOL = 1e-4, 1e-5

DET_PRUNE = dict(sampler_point_frac=0.5, with_topk_det=True, topk_det_list=(12, 6, 6),
                 operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 2)
MODE_PRUNE = dict(with_topk_mode=True, topk_mode_list=(3, 2), num_temp_plan_mode=2)


def test_prepare_keypoint_topk_matches_jax():
    """``prepare`` at ``sampler_point_frac=0.5``: 6 of 12 box anchors lie
    300 m below the rig, so every keypoint is outside every camera and all
    their importances tie at 0; the others have points in and out of the
    images. Kept points, their order and the renormalised weights agree to
    1e-5 of the largest value (fp32, sums in another order)."""
    rng = np.random.default_rng(21)
    n = 12
    anchor = _box_anchors(rng, n)
    anchor[:, ::2, :3] = (0.0, 0.0, -300.0)
    # the others a few metres in front of camera 0
    anchor[:, 1::2, :3] = rng.uniform((4.0, -3.0, -1.0), (12.0, 3.0, 1.0), (BS, n // 2, 3))
    f, e = (rng.normal(size=(BS, n, C)).astype(np.float32) for _ in range(2))
    proj = _projection(rng)
    wh = np.tile(np.array([96.0, 64.0], np.float32), (BS, CFG.num_cams, 1))
    tk, jk = tkps.BoxKeypoints(CFG.det_kps, C), jkps.BoxKeypoints(CFG.det_kps)
    _port_module(tk, seed=3)
    m = _port_module(tdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, tk.num_pts,
                                                sampler_cam_k=2, sampler_cam_renorm=True,
                                                sampler_point_frac=0.5))
    jm = jdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, kps=jk,
                                    sampler_cam_k=2, sampler_cam_renorm=True,
                                    sampler_matmul_levels=(2, 3), sampler_point_frac=0.5)
    v = {"params": {**_vars(m)["params"], "kps": _vars(tk)["params"]}}
    prepare = jax.jit(lambda *a: jm.apply(*a, method=jm.prepare))
    pts_ref, w_ref = prepare(v, _j(f), _j(anchor), _j(e), _j(proj), _j(wh))
    pts_got, w_got = m.prepare(tk, _t(f), _t(anchor), _t(e), _t(proj), _t(wh))
    kp = -(-tk.num_pts // 2)
    assert tuple(pts_got.shape) == (BS, n, kp, CFG.num_cams, 2)
    _close(pts_got, pts_ref, "prepare.points_2d (kept)")
    _close(w_got, w_ref, "prepare.weights (kept, renormalised)")

    m.point_frac = 1.0
    pts_all, _ = m.prepare(tk, _t(f), _t(anchor), _t(e), _t(proj), _t(wh))
    inside = ((pts_all > 0) & (pts_all < 1)).all(-1).any(-1).numpy()  # [bs, n, P]
    assert not inside[:, ::2].any(), "the low anchors must lie outside every camera"
    assert inside[:, 1::2].any() and not inside[:, 1::2].all(), \
        "the other anchors must have points in and out of the images"

    maps = _feature_maps(rng)
    m.point_frac = 0.5
    got = m(tk, _t(f), _t(anchor), _t(e), [_t(x) for x in maps], _t(proj), _t(wh))
    ref = jax.jit(jm.apply)(v, _j(f), _j(anchor), _j(e), [_j(x) for x in maps], _j(proj),
                            _j(wh))
    _close(got, ref, "DeformableAggregation at sampler_point_frac=0.5")


def _episode(cfg, seed=3):
    """Two frames (the second with the first's banks) through the port and
    through the JAX package, on the same weights -> [(port out, port banks,
    jax out, jax banks)] per frame."""
    batch = synthetic.make_batch(cfg, 2, seed=seed)
    model = _port(cfg)
    images, metas = batch_to_torch(batch, "cpu")
    metas2 = dict(metas, timestamp=metas["timestamp"] + 0.5)
    with torch.no_grad():
        t1, tb1 = model(images, metas)
        t2, tb2 = model(images + 0.1, metas2, tb1)
    jm = JHiPAD(cfg)
    variables = jax.tree_util.tree_map(jnp.asarray, model_to_jax(model))
    jmetas = {k: jnp.asarray(batch[k]) for k in META_KEYS}
    step = jax.jit(jm.apply)
    j1, jb1 = step(variables, jnp.asarray(batch["images"]), jmetas)
    j2, jb2 = step(variables, jnp.asarray(batch["images"]) + 0.1,
                   dict(jmetas, timestamp=jmetas["timestamp"] + 0.5), jb1)
    return [(t1, tb1, j1, jb1), (t2, tb2, j2, jb2)]


def model_to_jax(model):
    from hipad_torch.weights import to_jax

    return to_jax(model.state_dict())


@pytest.fixture(scope="module", params=["det_prune", "mode_prune"])
def episode(request):
    cfg = tiny(decoder_remat=False, **(DET_PRUNE if request.param == "det_prune"
                                       else MODE_PRUNE))
    return cfg, _episode(cfg)


def test_pruned_episode_matches_jax(episode):
    """Every output stack (every layer, full width) and every bank tensor of
    both frames. Det pruning: ``tiny`` with 3 refine layers, 12 det queries,
    merge at layer 0, 6 kept from layer 1 on, keypoint top-k 0.5. Plan-mode
    pruning: 3 then 2 of 3 modes per anchor group, 2 cached."""
    assert_episode_matches(episode[1])


def assert_episode_matches(frames):
    """:func:`_episode`'s frames: every output leaf and every bank tensor of
    both frames within the episode tolerance (ids and masks equal)."""
    checked = 0
    for frame, (tout, tb, jout, jb) in enumerate(frames):
        jleaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, jout)))
        tleaves = dict(_leaves(tout))
        assert set(tleaves) == set(jleaves), (frame, set(tleaves) ^ set(jleaves))
        pairs = [(f"out.{k}", tleaves[k], jleaves[k]) for k in sorted(jleaves)]
        jbank = {f"{n}.{f.name}": np.asarray(getattr(getattr(jb, n), f.name))
                 for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(tb, n))}
        pairs += [(f"bank.{k}", v, jbank[k]) for k, v in _bank_leaves(tb)]
        for name, got, ref in pairs:
            got = got.detach().numpy()
            assert got.shape == ref.shape, (frame, name, got.shape, ref.shape)
            if np.issubdtype(ref.dtype, np.integer) or ref.dtype == bool:
                np.testing.assert_array_equal(got, ref, err_msg=f"frame {frame + 1} {name}")
            else:
                err = np.abs(got.astype(np.float64) - ref).max()
                tol = RTOL * np.abs(ref).max() + ATOL
                assert err <= tol, f"frame {frame + 1} {name}: {err:.3e} > {tol:.3e}"
            checked += 1
    assert checked == 2 * (12 + 14)


def test_pruned_stacks_keep_their_frozen_rows(episode):
    """Det pruning: the slots dropped after layer 1 hold their layer-1 values
    bit for bit at layer 2, in the prediction, classification, quality and
    motion stacks, while the live slots move on. Plan-mode pruning: the
    padded modes of each layer carry cls -1e9 and reg +1e6."""
    cfg, frames = episode
    for frame, (tout, _, _, _) in enumerate(frames):
        if cfg.with_topk_det:
            n, nt = cfg.num_det_anchor, cfg.num_temp_det_anchor
            k = cfg.topk_det_list[1]
            tk = k * nt // n
            live = list(range(tk)) + list(range(nt, nt + k - tk))
            dropped = [i for i in range(n) if i not in live]
            for task, key in (("det", "prediction"), ("det", "classification"),
                              ("det", "quality"), ("motion", "prediction"),
                              ("motion", "classification")):
                stack = tout[task][key].numpy()
                np.testing.assert_array_equal(stack[2][:, dropped], stack[1][:, dropped],
                                              err_msg=f"frame {frame + 1} {task}.{key}")
            pred = tout["det"]["prediction"].numpy()
            assert not np.array_equal(pred[2][:, live], pred[1][:, live])
        else:
            ng, per = cfg.plan_anchor_group, cfg.ego_fut_cmd * cfg.ego_fut_mode
            cls = tout["plan"]["classification"].numpy().reshape(-1, 2, ng, per)
            reg = tout["plan"]["prediction"].numpy().reshape(-1, 2, ng, per, cfg.ego_fut_ts, 2)
            for layer, k in enumerate(cfg.topk_mode_list):
                assert (cls[layer, :, :, k:] == -1e9).all()
                assert (reg[layer, :, :, k:] == 1e6).all()
                assert (cls[layer, :, :, :k] > -1e8).all()
