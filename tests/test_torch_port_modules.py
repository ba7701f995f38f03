"""Each ported module family against its flax counterpart on the CPU, at
``tiny()`` widths.

Weights are drawn once for the port (``init_random`` plus random norms and
running statistics, so every layout rule is exercised) and carried to flax
with ``to_jax``; inputs are drawn with numpy from a seed. Unless a case says
otherwise, both sides run in fp32 and agree to ``RTOL`` of the largest
output value: the same arithmetic summed in another order.
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_tpu.core import geometry as jgeo
from hipad_tpu.models import attention_blocks as jattn
from hipad_tpu.models import backbone as jbb
from hipad_tpu.models import common as jcommon
from hipad_tpu.models import decoder as jdec
from hipad_tpu.models import deformable as jdef
from hipad_tpu.models import encoders as jenc
from hipad_tpu.models import instance_bank as jbank
from hipad_tpu.models import keypoints as jkps
from hipad_tpu.models import refine as jref
from hipad_torch.core import geometry as tgeo
from hipad_torch.models import attention_blocks as tattn
from hipad_torch.models import backbone as tbb
from hipad_torch.models import common as tcommon
from hipad_torch.models import decoder as tdec
from hipad_torch.models import deformable as tdef
from hipad_torch.models import encoders as tenc
from hipad_torch.models import instance_bank as tbank
from hipad_torch.models import keypoints as tkps
from hipad_torch.models import refine as tref
from hipad_torch.weights import init_random, to_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL = 1e-5
CFG = tiny(num_cams=3)
C = CFG.embed_dims
BS, N = 2, 10


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _port(mod: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded weights, then random norm affines and running statistics."""
    init_random(mod, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, (torch.nn.LayerNorm, tcommon.BatchNorm, tcommon.Scale)):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
            if isinstance(m, (torch.nn.LayerNorm, tcommon.BatchNorm)):
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, tcommon.BatchNorm):
                m.running_mean.copy_(0.2 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return mod.eval()


def _vars(mod: torch.nn.Module):
    return jax.tree_util.tree_map(jnp.asarray, to_jax(mod.state_dict()))


def _close(got, ref, what, rtol=RTOL):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-6)
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3e} > {rtol} x {scale:.3e}"


def _box_anchors(rng, n=N):
    a = np.zeros((BS, n, 11), np.float32)
    a[..., :3] = rng.uniform(-20, 20, (BS, n, 3))
    a[..., 3:6] = rng.uniform(-0.5, 1.5, (BS, n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (BS, n))
    a[..., 6], a[..., 7] = np.sin(yaw), np.cos(yaw)
    a[..., 8:] = rng.uniform(-3, 3, (BS, n, 3))
    return a


def _projection(rng):
    from hipad_torch.data.synthetic import _projection_matrices

    return _projection_matrices(CFG, np.random.RandomState(int(rng.integers(1000))), BS)


# ---------------------------------------------------------------- cases --

def case_geometry(rng):
    kp = rng.uniform(-30, 30, (BS, N, 5, 3)).astype(np.float32)
    proj = _projection(rng)
    wh = np.tile(np.array([96.0, 64.0], np.float32), (BS, CFG.num_cams, 1))
    _close(tgeo.project_points(_t(kp), _t(proj), _t(wh)),
           jgeo.project_points(_j(kp), _j(proj), _j(wh)), "project_points")
    anchor = _box_anchors(rng)
    T = np.tile(np.eye(4, dtype=np.float32), (BS, 1, 1))
    c, s = np.cos(0.3), np.sin(0.3)
    T[:, :2, :2] = [[c, -s], [s, c]]
    T[:, :3, 3] = rng.uniform(-2, 2, (BS, 3))
    dt = rng.uniform(-1, 1, BS).astype(np.float32)
    _close(tgeo.box_anchor_projection(_t(anchor), _t(T), _t(dt)),
           jgeo.box_anchor_projection(_j(anchor), _j(T), _j(dt)), "box_anchor_projection")
    pos = rng.uniform(-40, 40, (BS, N, 2)).astype(np.float32)
    _close(tgeo.sine_embed_2d(_t(pos), C), jgeo.sine_embed_2d(_j(pos), C), "sine_embed_2d")
    trajs = rng.normal(size=(BS, N, 3, 4, 2)).astype(np.float32)
    _close(tgeo.agent_to_lidar_trajs(_t(trajs), _t(anchor)),
           jgeo.agent_to_lidar_trajs(_j(trajs), _j(anchor)), "agent_to_lidar_trajs")


def case_common(rng):
    x = rng.normal(size=(BS, N, 12)).astype(np.float32)
    m = _port(tcommon.MLPLN(12, C, 2, 2))
    _close(m(_t(x)), jcommon.MLPLN(C, 2, 2).apply(_vars(m), _j(x)), "MLPLN")
    m = _port(tcommon.MLP(12, (C, C, 6)))
    _close(m(_t(x)), jcommon.MLP((C, C, 6)).apply(_vars(m), _j(x)), "MLP")
    m = _port(tcommon.Scale(12))
    _close(m(_t(x)), jcommon.Scale(12).apply(_vars(m), _j(x)), "Scale")
    x2 = rng.normal(size=(BS, N, 2 * C)).astype(np.float32)
    m = _port(tcommon.AsymmetricFFN(2 * C, C, 4 * C))
    _close(m(_t(x2)), jcommon.AsymmetricFFN(2 * C, C, 4 * C).apply(_vars(m), _j(x2)),
           "AsymmetricFFN")


@pytest.mark.parametrize("with_bias", [False, True])
def test_multihead_attention_matches_flax(with_bias):
    """MultiheadAttention with positional embeds, a separate key/value set
    and (optionally) an additive logit bias."""
    rng = np.random.default_rng(11)
    q, qp = (rng.normal(size=(BS, N, C)).astype(np.float32) for _ in range(2))
    k, kp = (rng.normal(size=(BS, 7, C)).astype(np.float32) for _ in range(2))
    bias = (rng.normal(size=(BS, CFG.num_groups, N, 7)).astype(np.float32) * 3
            if with_bias else None)
    m = _port(tcommon.MultiheadAttention(C, CFG.num_groups))
    got = m(_t(q), key=_t(k), query_pos=_t(qp), key_pos=_t(kp),
            attn_bias=None if bias is None else _t(bias))
    ref = jcommon.MultiheadAttention(C, CFG.num_groups).apply(
        _vars(m), _j(q), key=_j(k), query_pos=_j(qp), key_pos=_j(kp),
        attn_bias=None if bias is None else _j(bias))
    _close(got, ref, "MultiheadAttention")


def case_encoders(rng):
    anchor = _box_anchors(rng)
    dims = (C // 2, C // 8, C // 8, C // 4)
    m = _port(tenc.SparseBox3DEncoder(dims))
    _close(m(_t(anchor)), jenc.SparseBox3DEncoder(dims).apply(_vars(m), _j(anchor)),
           "SparseBox3DEncoder")
    poly = rng.uniform(-20, 20, (BS, N, 10)).astype(np.float32)
    m = _port(tenc.SparsePoint3DEncoder(10, C))
    _close(m(_t(poly)), jenc.SparsePoint3DEncoder(C).apply(_vars(m), _j(poly)),
           "SparsePoint3DEncoder")


def case_keypoints(rng):
    anchor = _box_anchors(rng)
    f = rng.normal(size=(BS, N, C)).astype(np.float32)
    m = _port(tkps.BoxKeypoints(CFG.det_kps, C))
    _close(m(_t(anchor), _t(f)),
           jkps.BoxKeypoints(CFG.det_kps).apply(_vars(m), _j(anchor), _j(f)), "BoxKeypoints")
    poly = rng.uniform(-20, 20, (BS, N, CFG.map_num_pts * 2)).astype(np.float32)
    m = _port(tkps.PointKeypoints(CFG.map_kps, C))
    _close(m(_t(poly), _t(f)),
           jkps.PointKeypoints(CFG.map_kps).apply(_vars(m), _j(poly), _j(f)), "PointKeypoints")


def case_refine(rng):
    f, e = (rng.normal(size=(BS, N, C)).astype(np.float32) for _ in range(2))
    anchor = _box_anchors(rng)
    ti = rng.uniform(0.3, 0.7, BS).astype(np.float32)
    m = _port(tref.SparseBox3DRefinement(CFG, 9))
    got = m(_t(f), _t(anchor), _t(e), _t(ti))
    ref = jref.SparseBox3DRefinement(CFG, 9).apply(_vars(m), _j(f), _j(anchor), _j(e), _j(ti))
    for g_, r_, name in zip(got, ref, ("reg", "cls", "quality")):
        _close(g_, r_, f"SparseBox3DRefinement.{name}")
    poly = rng.uniform(-20, 20, (BS, N, 10)).astype(np.float32)
    m = _port(tref.SparsePoint3DRefinement(CFG, 4, 10))
    got = m(_t(f), _t(poly), _t(e))
    ref = jref.SparsePoint3DRefinement(CFG, 4, 10).apply(_vars(m), _j(f), _j(poly), _j(e))
    _close(got[0], ref[0], "SparsePoint3DRefinement.reg")
    _close(got[1], ref[1], "SparsePoint3DRefinement.cls")
    m = _port(tref.EgoStatusRefinement(CFG))
    _close(m(_t(f[:, :1]), _t(e[:, :1])),
           jref.EgoStatusRefinement(CFG).apply(_vars(m), _j(f[:, :1]), _j(e[:, :1])),
           "EgoStatusRefinement")
    mq = rng.normal(size=(BS, N, CFG.fut_mode, C)).astype(np.float32)
    m = _port(tref.SparseMotionRefinement(CFG))
    got = m(_t(mq))
    ref = jref.SparseMotionRefinement(CFG).apply(_vars(m), _j(mq))
    _close(got[0], ref[0], "SparseMotionRefinement.cls")
    _close(got[1], ref[1], "SparseMotionRefinement.reg")
    n = CFG.num_plan_anchor
    pf, pe = (rng.normal(size=(BS, n, C)).astype(np.float32) for _ in range(2))
    pa = rng.uniform(-10, 10, (BS, n, CFG.ego_fut_ts * 2)).astype(np.float32)
    m = _port(tref.SparsePlanAlignRefinement(CFG))
    got = m(_t(pf), _t(pa), _t(pe))
    ref = jref.SparsePlanAlignRefinement(CFG).apply(_vars(m), _j(pf), _j(pa), _j(pe))
    _close(got[0], ref[0], "SparsePlanAlignRefinement.reg")
    _close(got[1], ref[1], "SparsePlanAlignRefinement.cls")


def _feature_maps(rng):
    return [rng.normal(size=(BS, CFG.num_cams, h, w, C)).astype(np.float32)
            for h, w in ((16, 24), (8, 12), (4, 6), (2, 3))]


@pytest.mark.parametrize("task", ["det", "map"])
def test_deformable_matches_flax(task):
    """``prepare`` (keypoints from the anchor embed for boxes, from the
    instance feature for polylines; the weights_fc output order and softmax
    axis), ``finish`` and the whole op with the stage-2 sampler."""
    rng = np.random.default_rng(12)
    if task == "det":
        anchor = _box_anchors(rng)
        tk, jk = tkps.BoxKeypoints(CFG.det_kps, C), jkps.BoxKeypoints(CFG.det_kps)
    else:
        # polylines around the ego so that many keypoints land in the images
        anchor = rng.uniform(-6, 6, (BS, N, CFG.map_num_pts * 2)).astype(np.float32)
        tk, jk = tkps.PointKeypoints(CFG.map_kps, C), jkps.PointKeypoints(CFG.map_kps)
    f, e = (rng.normal(size=(BS, N, C)).astype(np.float32) for _ in range(2))
    proj = _projection(rng)
    wh = np.tile(np.array([96.0, 64.0], np.float32), (BS, CFG.num_cams, 1))
    maps = _feature_maps(rng)
    _port(tk, seed=3)
    m = _port(tdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, tk.num_pts,
                                         sampler_cam_k=2, sampler_cam_renorm=True))
    jm = jdef.DeformableAggregation(C, CFG.num_groups, 4, CFG.num_cams, kps=jk,
                                    sampler_cam_k=2, sampler_cam_renorm=True,
                                    sampler_matmul_levels=(2, 3))
    v = {"params": {**_vars(m)["params"], "kps": _vars(tk)["params"]}}
    args = (_j(f), _j(anchor), _j(e), _j(proj), _j(wh))
    pts_ref, w_ref = jm.apply(v, *args, method=jm.prepare)
    pts_got, w_got = m.prepare(tk, _t(f), _t(anchor), _t(e), _t(proj), _t(wh))
    _close(pts_got, pts_ref, "prepare.points_2d")
    _close(w_got, w_ref, "prepare.weights")
    inside = ((np.asarray(pts_ref) > 0) & (np.asarray(pts_ref) < 1)).all(-1)
    assert inside.any(), "no keypoint lands in an image: the sampler is not exercised"
    _close(m.finish(_t(e), _t(f)), jm.apply(v, _j(e), _j(f), method=jm.finish), "finish")
    got = m(tk, _t(f), _t(anchor), _t(e), [_t(x) for x in maps], _t(proj), _t(wh))
    ref = jm.apply(v, _j(f), _j(anchor), _j(e), [_j(x) for x in maps], _j(proj), _j(wh))
    _close(got, ref, "DeformableAggregation")


def _det_state(rng, t_cls=tbank.DetBankState):
    K, n = CFG.num_temp_det_anchor, CFG.num_det_anchor
    conf = rng.choice([0.1, 0.3, 0.7], (BS, K)).astype(np.float32)  # ties
    fields = dict(
        feature=rng.normal(size=(BS, K, C)).astype(np.float32),
        anchor=_box_anchors(rng, K),
        confidence=conf,
        instance_id=np.where(rng.uniform(size=(BS, n)) < 0.5, -1,
                             rng.integers(0, 50, (BS, n))).astype(np.int32),
        prev_id=np.array([50, 60], np.int32),
        timestamp=np.array([0.0, -5.0], np.float32),  # sample 1: gap too long
        t_global=np.tile(np.eye(4, dtype=np.float32), (BS, 1, 1)),
    )
    return fields


def case_instance_bank(rng):
    n, K = CFG.num_det_anchor, CFG.num_temp_det_anchor
    fields = _det_state(rng)
    ts = torch.from_numpy
    tstate = tbank.DetBankState(**{k: ts(v) for k, v in fields.items()})
    jstate = jbank.DetBankState(**{k: jnp.asarray(v) for k, v in fields.items()})
    now = np.array([0.5, 0.5], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (BS, 1, 1))
    T[:, 0, 3] = [1.0, -2.0]
    Tinv = np.linalg.inv(T).astype(np.float32)

    got = tbank.det_bank_get(CFG, tstate, BS, ts(now), ts(T), ts(Tinv))
    ref = jbank.det_bank_get(CFG, jstate, BS, jnp.asarray(now), jnp.asarray(T),
                             jnp.asarray(Tinv))
    for g_, r_, name in zip(got, ref, ("feature", "anchor", "time_interval", "mask")):
        _close(g_.float() if name == "mask" else g_, np.asarray(r_, np.float32),
               f"det_bank_get.{name}")
    _, temp_anchor, _, mask = got

    feat = rng.normal(size=(BS, n, C)).astype(np.float32)
    anchor = _box_anchors(rng, n)
    cls = rng.choice([-1.0, 0.5, 2.0], (BS, n, 9)).astype(np.float32)  # ties in the max
    g_upd = tbank.det_bank_update(CFG, tstate, ts(fields["feature"]), temp_anchor,
                                  ts(feat), ts(anchor), ts(cls), mask)
    r_upd = jbank.det_bank_update(CFG, jstate, jnp.asarray(fields["feature"]),
                                  jnp.asarray(temp_anchor.numpy()), jnp.asarray(feat),
                                  jnp.asarray(anchor), jnp.asarray(cls), jnp.asarray(mask.numpy()))
    _close(g_upd[0], r_upd[0], "det_bank_update.feature")
    _close(g_upd[1], r_upd[1], "det_bank_update.anchor")
    _close(g_upd[2].confidence, r_upd[2].confidence, "det_bank_update.confidence")
    np.testing.assert_array_equal(g_upd[2].instance_id.numpy(), np.asarray(r_upd[2].instance_id))

    for prev in (None, fields["confidence"]):
        g_st, g_tc = tbank.det_bank_cache(CFG, None if prev is None else ts(prev), ts(feat),
                                          ts(anchor), ts(cls), ts(now), ts(T))
        r_st, r_tc = jbank.det_bank_cache(CFG, None if prev is None else jnp.asarray(prev),
                                          jnp.asarray(feat), jnp.asarray(anchor),
                                          jnp.asarray(cls), jnp.asarray(now), jnp.asarray(T))
        _close(g_tc, r_tc, "det_bank_cache.temp_confidence")
        for fld in ("feature", "anchor", "confidence"):
            _close(getattr(g_st, fld), getattr(r_st, fld), f"det_bank_cache.{fld}")
        for old_t, old_j in ((None, None), (tstate, jstate)):
            g_ids, g_new = tbank.det_assign_instance_ids(CFG, old_t, g_st, g_tc, ts(cls))
            r_ids, r_new = jbank.det_assign_instance_ids(CFG, old_j, r_st, r_tc,
                                                         jnp.asarray(cls))
            np.testing.assert_array_equal(g_ids.numpy(), np.asarray(r_ids))
            np.testing.assert_array_equal(g_new.instance_id.numpy(), np.asarray(r_new.instance_id))
            np.testing.assert_array_equal(g_new.prev_id.numpy(), np.asarray(r_new.prev_id))

    g = CFG.plan_anchor_group * CFG.ego_fut_cmd
    pf = rng.normal(size=(BS, CFG.num_plan_anchor, C)).astype(np.float32)
    pa = rng.normal(size=(BS, CFG.num_plan_anchor, CFG.ego_fut_ts * 2)).astype(np.float32)
    pc = rng.choice([-1.0, 0.0, 1.0], (BS, CFG.num_plan_anchor, 1)).astype(np.float32)
    prev = rng.uniform(size=(BS, g, CFG.num_temp_plan_mode)).astype(np.float32)
    g_pl = tbank.plan_bank_cache(CFG, ts(prev), ts(pf), ts(pa), ts(pc), ts(now))
    r_pl = jbank.plan_bank_cache(CFG, jnp.asarray(prev), jnp.asarray(pf), jnp.asarray(pa),
                                 jnp.asarray(pc), jnp.asarray(now))
    for fld in ("feature", "anchor", "confidence"):
        _close(getattr(g_pl, fld), getattr(r_pl, fld), f"plan_bank_cache.{fld}")
    g_tf, g_ta = tbank.plan_bank_get(CFG, g_pl)
    r_tf, r_ta = jbank.plan_bank_get(CFG, r_pl)
    _close(g_tf, r_tf, "plan_bank_get.feature")
    _close(g_ta, r_ta, "plan_bank_get.anchor")
    np.testing.assert_array_equal(tbank.det_cold_layout(CFG), jbank.det_cold_layout(CFG))


class _JGroupedAttention(fnn.Module):
    """Flax host for GroupedCrossAttention and its shared fc_before/after."""

    groups: tuple

    @fnn.compact
    def __call__(self, x, pos, sections, **kw):
        fb = fnn.Dense(2 * C, use_bias=False, name="fc_before")
        fa = fnn.Dense(C, use_bias=False, name="fc_after")
        return jattn.GroupedCrossAttention(C, CFG.num_groups, self.groups, name="gca")(
            x, pos, sections, fb, fa, **kw)


class _TGroupedAttention(torch.nn.Module):
    def __init__(self, groups):
        super().__init__()
        self.fc_before = torch.nn.Linear(C, 2 * C, bias=False)
        self.fc_after = torch.nn.Linear(2 * C, C, bias=False)
        self.gca = tattn.GroupedCrossAttention(C, CFG.num_groups, groups)

    def forward(self, x, pos, sections, **kw):
        return self.gca(x, pos, sections, self.fc_before, self.fc_after, **kw)


@pytest.mark.parametrize("flavour", ["gnn", "temp_first_frame", "temp", "inter"])
def test_grouped_attention_matches_flax(flavour):
    """The three attention flavours of the decoder, including the first
    frame's temporal op (no keys: self-attention, decoupled value = key
    concat) and an empty key section (map has no temporal instances)."""
    rng = np.random.default_rng(13)
    counts = {"det": 6, "map": 3, "plan": 4, "ego": 1}
    sections, s = {}, 0
    for q in CFG.query_select:
        sections[q] = (s, s + counts[q])
        s += counts[q]
    x, pos = (rng.normal(size=(BS, s, C)).astype(np.float32) for _ in range(2))
    kw_t, kw_j = {}, {}
    if flavour == "gnn":
        groups = tattn.self_attention_groups([("det",), ("map",)], [True, False])
    elif flavour == "inter":
        groups = tattn.cross_attention_groups([("plan", "ego")], [("det", "map")], [False])
        kw_t = dict(key_x=_t(x), key_pos=_t(pos), key_sections=sections)
        kw_j = dict(key_x=_j(x), key_pos=_j(pos), key_sections=sections)
    else:
        groups = tattn.cross_attention_groups(
            [("det",), ("map",), ("plan", "ego")], [("det",), ("map",), ("det", "map")],
            [True, False, False])
        if flavour == "temp_first_frame":
            kw_t = kw_j = dict(has_value=False)
        else:
            tcounts = {"det": 3, "map": 0, "plan": 2, "ego": 1}
            ts_, s2 = {}, 0
            for q in CFG.query_select:
                ts_[q] = (s2, s2 + tcounts[q])
                s2 += tcounts[q]
            kx, kp = (rng.normal(size=(BS, s2, C)).astype(np.float32) for _ in range(2))
            kw_t = dict(key_x=_t(kx), key_pos=_t(kp), key_sections=ts_)
            kw_j = dict(key_x=_j(kx), key_pos=_j(kp), key_sections=ts_)
    m = _port(_TGroupedAttention(groups))
    got = m(_t(x), _t(pos), sections, **kw_t)
    ref = _JGroupedAttention(groups).apply(_vars(m), _j(x), _j(pos), sections, **kw_j)
    _close(got, ref, f"GroupedCrossAttention[{flavour}]")


def test_backbone_matches_flax():
    """ResNet + FPN with one block per stage at tiny widths (NCHW
    channels_last inside, NHWC out), BatchNorm from running statistics."""
    rng = np.random.default_rng(14)
    images = rng.normal(size=(1, CFG.num_cams, 64, 96, 3)).astype(np.float32)
    m = _port(tbb.ResNetFPN((1, 1, 1, 1), 8, C)).to(memory_format=torch.channels_last)
    got = m(_t(images))
    ref = jbb.ResNetFPN((1, 1, 1, 1), 8, C).apply(_vars(m), _j(images))
    assert len(got) == len(ref) == 4
    for lvl, (g_, r_) in enumerate(zip(got, ref)):
        _close(g_, r_, f"ResNetFPN level {lvl}", rtol=1e-4)


def test_r101_backbone_matches_flax():
    """ResNet-101's stages (3-4-23-3 Bottleneck blocks, the
    ``stage2_r101_2x`` trunk) + FPN at tiny widths: every block after a
    stage's first adds its input through the identity shortcut."""
    rng = np.random.default_rng(16)
    images = rng.normal(size=(1, CFG.num_cams, 64, 96, 3)).astype(np.float32)
    m = _port(tbb.ResNetFPN((3, 4, 23, 3), 8, C)).to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = m(_t(images))
    ref = jbb.ResNetFPN((3, 4, 23, 3), 8, C).apply(_vars(m), _j(images))
    assert len(got) == len(ref) == 4
    for lvl, (g_, r_) in enumerate(zip(got, ref)):
        _close(g_, r_, f"ResNet-101 FPN level {lvl}", rtol=1e-4)


@pytest.mark.parametrize("hw", [(5, 7), (6, 10)])
def test_front_view_encoder_matches_flax(hw):
    """FrontViewEncoder on odd and even maps: the mean over the FIRST pooling
    window, sized from the pre-conv dims."""
    rng = np.random.default_rng(15)
    fmap = rng.normal(size=(BS,) + hw + (C,)).astype(np.float32)
    m = _port(tdec.FrontViewEncoder(C))
    _close(m(_t(fmap)), jdec.FrontViewEncoder(C).apply(_vars(m), _j(fmap)),
           "FrontViewEncoder")


CASES = {
    "geometry": case_geometry,
    "common": case_common,
    "encoders": case_encoders,
    "keypoints": case_keypoints,
    "refine": case_refine,
    "instance_bank": case_instance_bank,
}


@pytest.mark.parametrize("family", sorted(CASES))
def test_module_family_matches_flax(family):
    with torch.no_grad():
        CASES[family](np.random.default_rng(sorted(CASES).index(family)))


def test_topk_gather_breaks_ties_to_lower_index():
    conf = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    x = torch.arange(5.0)[None, :, None]
    got_conf, (got,) = tbank.topk_gather(conf, 4, x)
    ref_conf, ref_idx = jax.lax.top_k(jnp.asarray(conf.numpy()), 4)
    np.testing.assert_array_equal(got[0, :, 0].numpy(), np.asarray(ref_idx[0], np.float32))
    np.testing.assert_array_equal(got_conf.numpy(), np.asarray(ref_conf))
    assert dataclasses.is_dataclass(tbank.BankStates)
