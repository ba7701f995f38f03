"""Point-expanded map and plan queries in the port against the JAX package
on the CPU at ``tiny()``, fp32:

  * ``with_concat_{map,plan}_points``: each query expanded into its polyline
    points in the concat op and squeezed back in the split op;
  * ``with_deform_{map,plan}_points``: the per-point embeds into the
    deformable op's weights head;

each alone: the per-point encoder and the weights head against flax, the
parameters as ``tests/test_optional_features.py:39-95`` finds them, and a
two-frame episode; all four together: one training step, every loss and
gradient leaf; and the configuration refusing the concat options together
with the attention masks, as the JAX package's does.
"""

import os

import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.data import synthetic
from hipad_torch.models import deformable as tdef
from hipad_torch.models import encoders as tenc
from hipad_torch.models import keypoints as tkps
from hipad_torch.models.detector import HiPAD
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
from hipad_tpu.configs.model import tiny as jtiny
from hipad_tpu.models import deformable as jdef
from hipad_tpu.models import encoders as jenc
from hipad_tpu.models import keypoints as jkps
from test_torch_port_modules import (BS, CFG, C, _close, _feature_maps, _j, _port, _projection,
                                     _t, _vars)
from test_torch_serve_model import _episode, assert_episode_matches
from test_torch_train_ddp import at_most_one_box_per_anchor
from test_torch_train_stage1 import (NO_DROP, assert_step_matches, jax_step, port_result,
                                     step_batch, warm_banks)
from test_torch_train_step import _port as _port_model

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CONCAT = dict(with_concat_map_points=True, with_concat_plan_points=True)
DEFORM = dict(with_deform_map_points=True, with_deform_plan_points=True)
OPTIONS = {"concat": CONCAT, "deform": DEFORM}


def test_keypoint_encoder_matches_flax():
    """The instance embed of the flattened polyline and the per-point embed
    of each point's (x, y), interleaved point after point of each anchor."""
    rng = np.random.default_rng(1)
    poly = rng.uniform(-20, 20, (BS, 7, CFG.map_num_pts * 2)).astype(np.float32)
    m = _port(tenc.KeyPoint3DEncoder(C, CFG.map_num_pts))
    got = m(_t(poly))
    ref = jenc.KeyPoint3DEncoder(C, num_sample=CFG.map_num_pts).apply(_vars(m), _j(poly))
    assert tuple(got[1].shape) == (BS, 7 * CFG.map_num_pts, C)
    _close(got[0], ref[0], "KeyPoint3DEncoder instance embed")
    _close(got[1], ref[1], "KeyPoint3DEncoder points embed")


def test_deformable_weights_head_takes_point_embeds():
    """``use_points_embed = S``: the weights head reads each anchor's S
    points' (feature + point embed) side by side, ``S * C`` wide; ``prepare``
    and the whole op against flax."""
    rng = np.random.default_rng(2)
    n, S = 6, CFG.map_num_pts
    anchor = rng.uniform(-6, 6, (BS, n, S * 2)).astype(np.float32)
    f = rng.normal(size=(BS, n, C)).astype(np.float32)
    e = rng.normal(size=(BS, n * S, C)).astype(np.float32)
    proj = _projection(rng)
    wh = np.tile(np.array([96.0, 64.0], np.float32), (BS, CFG.num_cams, 1))
    tk, jk = tkps.PointKeypoints(CFG.map_kps, C), jkps.PointKeypoints(CFG.map_kps)
    _port(tk, seed=3)
    m = _port(tdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, tk.num_pts,
                                         sampler_cam_k=2, sampler_cam_renorm=True,
                                         use_points_embed=S))
    assert tuple(m.weights_fc.weight.shape[1:]) == (S * C,)
    jm = jdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, kps=jk,
                                    sampler_cam_k=2, sampler_cam_renorm=True,
                                    sampler_matmul_levels=(2, 3), use_points_embed=S)
    v = {"params": {**_vars(m)["params"], "kps": _vars(tk)["params"]}}
    pts_ref, w_ref = jm.apply(v, _j(f), _j(anchor), _j(e), _j(proj), _j(wh), method=jm.prepare)
    pts_got, w_got = m.prepare(tk, _t(f), _t(anchor), _t(e), _t(proj), _t(wh))
    _close(pts_got, pts_ref, "prepare.points_2d (points embed)")
    _close(w_got, w_ref, "prepare.weights (points embed)")
    maps = _feature_maps(rng)
    got = m(tk, _t(f), _t(anchor), _t(e), [_t(x) for x in maps], _t(proj), _t(wh))
    ref = jm.apply(v, _j(f), _j(anchor), _j(e), [_j(x) for x in maps], _j(proj), _j(wh))
    _close(got, ref, "DeformableAggregation (points embed)")


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_point_expansion_params_exist_and_shared(option):
    """The per-point encoders replace the flat ones; with concat the two
    squeeze MLPs (shared by every split op) have the reference's widths;
    with deform every map and plan weights head is ``points * C`` wide."""
    cfg = tiny(**OPTIONS[option])
    dec = HiPAD(cfg, device="cpu").decoder
    names = set(dec.state_dict())
    for q in ("map", "plan"):
        assert isinstance(getattr(dec, f"{q}_anchor_encoder"), tenc.KeyPoint3DEncoder)
        assert f"{q}_anchor_encoder.embed_points.fc_0_0.weight" in names
        assert f"{q}_anchor_encoder.embed_instance.fc_0_0.weight" in names
    squeeze = {k.split(".")[0] for k in names if k.startswith("squeeze_")}
    if option == "concat":
        assert squeeze == {"squeeze_map_instance", "squeeze_plan_instance"}
        assert tuple(dec.squeeze_map_instance.fc_0.weight.shape) == (
            cfg.map_num_pts * C // 4, cfg.map_num_pts * C)
        assert tuple(dec.squeeze_plan_instance.fc_0.weight.shape) == (
            cfg.ego_fut_ts * C // 2, cfg.ego_fut_ts * C)
    else:
        assert not squeeze
    n_deform = cfg.operation_order.count("deformable")
    for i in range(n_deform):
        for q, pts in (("map", cfg.map_num_pts), ("plan", cfg.ego_fut_ts)):
            width = getattr(dec, f"{q}_deformable_{i}").weights_fc.weight.shape[1]
            assert width == (pts * C if option == "deform" else C), (q, i, width)
        assert getattr(dec, f"det_deformable_{i}").weights_fc.weight.shape[1] == C


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_point_expansion_episode_matches_jax(option):
    """Two frames, the second on the first's banks (the plan bank's queries
    expanded in the temporal op as well): every output stack, at the
    anchor-level layout, and every bank tensor."""
    cfg = tiny(decoder_remat=False, **OPTIONS[option])
    frames = _episode(cfg)
    out = frames[0][0]
    assert out["map"]["prediction"].shape[2] == cfg.num_map_anchor
    assert out["plan"]["prediction"].shape[3] == cfg.num_plan_anchor
    assert_episode_matches(frames)


def test_point_expansion_training_step_matches_jax():
    """One training step with all four options on, from the banks of one
    eval frame, against the JAX package's step: every loss, the gradient
    norm, every gradient leaf (the squeeze MLPs' among them, not zero),
    running statistics, banks and the parameters after the update. At most
    one GT box per det anchor, as ``test_torch_train_ddp.py`` keeps them:
    with more, JAX's fp32 matcher can miss scipy's optimum (ROADMAP queue 3,
    "Ties")."""
    cfg = tiny(**NO_DROP, **CONCAT, **DEFORM)
    batch = at_most_one_box_per_anchor(cfg, synthetic.make_batch(cfg, 2, seed=3))
    model = _port_model(cfg)
    banks = warm_banks(model, batch)
    ref = jax_step(cfg, model.state_dict(), step_batch(batch), banks)
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    new_banks, metrics = step(banks, {k: torch.as_tensor(v) for k, v in step_batch(batch).items()},
                              torch.Generator().manual_seed(0))
    got = port_result(model, metrics, new_banks)
    assert_step_matches(got, ref)
    for q in ("map", "plan"):
        assert np.abs(got["grads"][f"decoder.squeeze_{q}_instance.fc_0.kernel"]).max() > 0


@pytest.mark.parametrize("mask", ["with_distance_attn_mask", "with_velocity_attn_mask"])
def test_concat_points_with_attn_masks_are_refused(mask):
    """The biases are sized from the anchor counts, the inter_gnn sections
    from the expanded points: both packages' configurations refuse the
    pair."""
    for make in (tiny, jtiny):
        with pytest.raises(ValueError, match="incompatible"):
            make(with_concat_plan_points=True, **{mask: True})
