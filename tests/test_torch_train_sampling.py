"""Gradients of the port's sampler (the plain versions of kernels K1 and K2,
whose autograd is what the backward kernels K1-bwd and K2-bwd are held to on
the card) against the JAX package's adjoints on the CPU.

K1's reference is ``jax.vjp`` of ``_interp_matmul_level`` and of
``interp_matmul_camsum``, and the Pallas kernel's own ``custom_vjp``
(``_interp_matmul_tpu``, run in interpret mode). K2's is the hand-written
adjoint of ``patch_bilinear_w`` (``_patch_bilinear_w_bwd`` with
``_dense_fmap_grad``), directly and as ``deformable_samples_topk_flat``
drives it. Every gradient input: feature maps, coordinates, group weights.
Some coordinates sit exactly on integers, where the hat weights have kinks
and both packages must take the same one-sided convention.

Inputs are drawn with numpy from a seed; fp32 on both sides unless stated.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_tpu.ops import pallas_interp
from hipad_tpu.ops import sampling as jsam
from hipad_torch.ops import sampling as tsam

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# fp32 gradients summed in another order on the two sides (over channels,
# taps, cameras and samples): a few ulp of the largest value of each.
GRAD_RTOL = 2e-5

BS, CAMS, C, G = 2, 3, 32, 4
H, W, M = 6, 10, 200


def _close(got, ref, rtol, what):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert scale > 0, what
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3e} > {rtol} x {scale:.3e}"


def _leaves(*arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]


def _interp_inputs(seed):
    rng = np.random.default_rng(seed)
    fm = rng.standard_normal((BS * CAMS, H, W, C)).astype(np.float32)
    px = rng.uniform(-1.5, W + 0.5, (BS * CAMS, M)).astype(np.float32)
    py = rng.uniform(-1.5, H + 0.5, (BS * CAMS, M)).astype(np.float32)
    # kinks: coordinates on integers, including the map's borders -1 and W
    px[:, ::7] = np.round(px[:, ::7])
    py[:, ::5] = np.round(py[:, ::5])
    px[0, :3] = (-1.0, float(W), 0.0)
    wg = rng.uniform(0, 1, (BS * CAMS, M, G)).astype(np.float32)
    wg *= rng.uniform(size=(BS * CAMS, M, 1)) < 0.7
    return fm, px, py, wg


def test_interp_level_grads_match_jax():
    """K1's building block: ``interp_matmul_level`` against ``jax.vjp`` of
    ``_interp_matmul_level``, gradients to fm, px, py and wg."""
    fm, px, py, wg = _interp_inputs(11)
    g = np.random.default_rng(12).standard_normal((BS * CAMS, M, G, C // G)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jsam._interp_matmul_level(*a, G), *map(jnp.asarray,
                                                                      (fm, px, py, wg)))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(fm, px, py, wg)
    out = tsam.interp_matmul_level(*leaves, G)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("fm", "px", "py", "wg"), got, ref):
        _close(a, b, GRAD_RTOL, f"interp_matmul_level d{name}")


def test_interp_camsum_grads_match_jax():
    """K1's plain version ``interp_matmul_camsum`` (the camera sum included)
    against ``jax.vjp`` of the JAX package's ``interp_matmul_camsum``."""
    fm, px, py, wg = _interp_inputs(13)
    g = np.random.default_rng(14).standard_normal((BS, M, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jsam.interp_matmul_camsum(*a, G, BS, CAMS),
                     *map(jnp.asarray, (fm, px, py, wg)))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(fm, px, py, wg)
    got = torch.autograd.grad(tsam.interp_matmul_camsum(*leaves, BS, CAMS), leaves,
                              torch.from_numpy(g))
    for name, a, b in zip(("fm", "px", "py", "wg"), got, ref):
        _close(a, b, GRAD_RTOL, f"interp_matmul_camsum d{name}")


class _InterpretPallas:
    """Stands in for ``jax.experimental.pallas`` inside pallas_interp: every
    ``pallas_call`` runs in interpret mode on the CPU."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def test_pallas_custom_vjp_matches_port(monkeypatch):
    """The TPU kernel's ``custom_vjp`` (``_interp_matmul_tpu``: the Pallas
    forward in interpret mode, ``_interp_matmul_tpu_bwd`` backward) against
    autograd of K1's plain version, fp32 map. The kernel's padded
    ``[B, Mp, C]`` cotangent rows beyond M are ignored by its backward."""
    monkeypatch.setattr(pallas_interp, "pl", _InterpretPallas(pallas_interp.pl))
    fm, px, py, wg = _interp_inputs(15)
    args = tuple(map(jnp.asarray, (fm, px, py, wg)))
    out, vjp = jax.vjp(lambda *a: jsam._interp_matmul_tpu(*a, G), *args)
    g = np.random.default_rng(16).standard_normal(out.shape).astype(np.float32)
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(fm, px, py, wg)
    got = torch.autograd.grad(tsam.interp_matmul_level(*leaves, G), leaves,
                              torch.from_numpy(g[:, :M]).reshape(BS * CAMS, M, G, C // G))
    for name, a, b in zip(("fm", "px", "py", "wg"), got, ref):
        _close(a, b, GRAD_RTOL, f"_interp_matmul_tpu (Pallas, interpret) d{name}")


def _patch_inputs(seed, maps_hw=((12, 20), (6, 10))):
    rng = np.random.default_rng(seed)
    cam_k, m0 = 2, 120
    m = m0 * cam_k
    maps = [rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32) for h, w in maps_hw]
    cam = rng.integers(0, CAMS, (BS, m)).astype(np.int32)
    x = rng.uniform(-0.1, 1.1, (BS, m)).astype(np.float32)
    y = rng.uniform(-0.1, 1.1, (BS, m)).astype(np.float32)
    # kinks: locations on level 0's pixel corners
    w0, h0 = maps_hw[0][1], maps_hw[0][0]
    x[:, ::6] = (np.round(x[:, ::6] * w0 - 0.5) + 0.5) / w0
    y[:, ::9] = (np.round(y[:, ::9] * h0 - 0.5) + 0.5) / h0
    w = rng.uniform(0, 1, (BS, m, len(maps), G)).astype(np.float32)
    return maps, cam, x, y, w, cam_k


def test_patch_sample_grads_match_patch_bilinear_w():
    """K2's plain version against the JAX hand-written adjoint of
    ``patch_bilinear_w`` per fine level (hat weights built from the
    continuous coordinates as ``deformable_samples_topk_flat`` builds them),
    summed over the cam_k slots and the levels: gradients to every map, x, y
    and the group weights."""
    maps, cam, x, y, w, cam_k = _patch_inputs(21)
    m0 = x.shape[1] // cam_k
    g = np.random.default_rng(22).standard_normal((BS, m0, C)).astype(np.float32)

    def jax_fn(maps, x, y, w):
        out = 0.0
        two = jnp.arange(2, dtype=jnp.float32)
        for lvl, feat in enumerate(maps):
            h, wl = feat.shape[2:4]
            px, py = x * wl - 0.5, y * h - 0.5
            sy = jnp.clip(jnp.floor(py), 0, h - 2).astype(jnp.int32)
            sx = jnp.clip(jnp.floor(px), 0, wl - 2).astype(jnp.int32)
            wy = jnp.maximum(0.0, 1.0 - jnp.abs(py[..., None] - (sy[..., None] + two)))
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(px[..., None] - (sx[..., None] + two)))
            s = jsam.patch_bilinear_w(feat, jnp.asarray(cam), sy, sx, wy, wx, w[:, :, lvl])
            out = out + s.reshape(BS, m0, cam_k, C).sum(axis=2)
        return out

    _, vjp = jax.vjp(jax_fn, [jnp.asarray(f) for f in maps], jnp.asarray(x), jnp.asarray(y),
                     jnp.asarray(w))
    ref_maps, *ref = vjp(jnp.asarray(g))
    lm = _leaves(*maps)
    lx, ly, lw = _leaves(x, y, w)
    out = tsam.patch_sample(lm, torch.from_numpy(cam), lx, ly, lw, cam_k)
    got = torch.autograd.grad(out, lm + [lx, ly, lw], torch.from_numpy(g))
    for lvl, (a, b) in enumerate(zip(got[:len(maps)], ref_maps)):
        _close(a, b, GRAD_RTOL, f"patch_sample d level {lvl}")
    for name, a, b in zip(("x", "y", "w"), got[len(maps):], ref):
        _close(a, b, GRAD_RTOL, f"patch_sample d{name}")


@pytest.mark.parametrize("cam_renorm", [True, False])
def test_topk_flat_grads_match_jax(cam_renorm):
    """The stage-2 sampler (camera top-k, K2 on levels 0-1, K1 on levels
    2-3) end to end: gradients to the four maps, the points and the weights
    against ``jax.vjp`` of ``deformable_samples_topk_flat``, whose fine
    levels run ``patch_bilinear_w``."""
    rng = np.random.default_rng(31 + cam_renorm)
    hw = ((12, 20), (6, 10), (3, 5), (2, 3))
    maps = [rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32) for h, w in hw]
    m0 = 90
    pts = rng.uniform(-0.3, 1.3, (BS, m0, CAMS, 2)).astype(np.float32)
    logits = rng.standard_normal((BS, m0, CAMS * len(hw), G))
    wts = (np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)).astype(np.float32)
    wts = wts.reshape(BS, m0, CAMS, len(hw), G)
    g = rng.standard_normal((BS, m0, C)).astype(np.float32)

    def jax_fn(maps, pts, wts):
        return jsam.deformable_samples_topk_flat(maps, pts, wts, cam_k=2, matmul_levels=(2, 3),
                                                 cam_renorm=cam_renorm)

    _, vjp = jax.vjp(jax_fn, [jnp.asarray(f) for f in maps], jnp.asarray(pts),
                     jnp.asarray(wts))
    ref_maps, ref_pts, ref_w = vjp(jnp.asarray(g))
    lm = _leaves(*maps)
    lp, lw = _leaves(pts, wts)
    out = tsam.deformable_samples_topk_flat(lm, lp, lw, cam_k=2, matmul_levels=(2, 3),
                                            cam_renorm=cam_renorm)
    got = torch.autograd.grad(out, lm + [lp, lw], torch.from_numpy(g))
    for lvl, (a, b) in enumerate(zip(got[:4], ref_maps)):
        _close(a, b, GRAD_RTOL, f"topk_flat d level {lvl}")
    _close(got[4], ref_pts, GRAD_RTOL, "topk_flat d points")
    _close(got[5], ref_w, GRAD_RTOL, "topk_flat d weights")


def _coarse_inputs(seed, dtype):
    """Levels 2-3 of a 4-level pyramid, ``[BS, m0, CAMS, 2]`` points reaching
    past the unit square, every 5th on level 2's pixel centres (integer pixel
    coordinates: kinks), the weights of all 4 levels, an acc and the output's
    gradient; maps and weights in ``dtype``."""
    rng = np.random.default_rng(seed)
    hw, m0 = ((6, 10), (3, 5)), 150
    maps = [rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32) for h, w in hw]
    pts = rng.uniform(-0.3, 1.3, (BS, m0, CAMS, 2)).astype(np.float32)
    n = len(range(0, m0, 5))
    pts[:, ::5, :, 0] = (rng.integers(0, hw[0][1], (BS, n, CAMS)) + 0.5) / hw[0][1]
    pts[:, ::5, :, 1] = (rng.integers(0, hw[0][0], (BS, n, CAMS)) + 0.5) / hw[0][0]
    w = rng.uniform(0, 1, (BS, m0, CAMS, 4, G)).astype(np.float32)
    acc = rng.standard_normal((BS, m0, C)).astype(np.float32)
    g = rng.standard_normal((BS, m0, C)).astype(np.float32)
    tmaps = [torch.from_numpy(f).to(dtype) for f in maps]
    return tmaps, torch.from_numpy(pts), torch.from_numpy(w).to(dtype), torch.from_numpy(acc), \
        torch.from_numpy(g)


def _plain_level_adjoint(fm, px, py, wg, gout, bs, cams):
    """Autograd of ``interp_matmul_camsum``: what K1-bwd computes on the card
    (also inside a backward, where grad mode is off)."""
    leaves = [t.detach().requires_grad_() for t in (fm, px, py, wg)]
    with torch.enable_grad():
        return torch.autograd.grad(tsam.interp_matmul_camsum(*leaves, bs, cams), leaves, gout)


def _coarse_plain_grads(maps, pts, w, acc, g, levels):
    """Autograd through ``coarse_sample_plain`` -> (d acc, d maps, d points,
    d weights)."""
    lacc, lp, lw = (t.detach().clone().requires_grad_() for t in (acc, pts, w))
    lm = [m.detach().clone().requires_grad_() for m in maps]
    out = tsam.coarse_sample_plain(lacc, lm, lp, lw, levels)
    got = torch.autograd.grad(out, [lacc, *lm, lp, lw], g)
    return got[0], list(got[1:-2]), got[-2], got[-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coarse_sample_backward_chain_matches_autograd(dtype):
    """The chain of K1's autograd Function (``coarse_sample_backward``: one
    adjoint call per coarse level, then ``d px * W``, ``d py * H`` and
    ``d wg * inside`` mapped back to the points and weights), run with
    autograd of ``interp_matmul_camsum`` in K1-bwd's place, against autograd
    through ``coarse_sample_plain``. Both take the same fp32 operations: the
    gradients agree to GRAD_RTOL, and in bf16 (maps, weights) each is
    rounded once from those fp32 values."""
    maps, pts, w, acc, g = _coarse_inputs(41, dtype)
    levels = (2, 3)
    ref_acc, ref_maps, ref_pts, ref_w = _coarse_plain_grads(maps, pts, w, acc, g, levels)
    dmaps, dpts, dw = tsam.coarse_sample_backward(g, maps, pts, w, levels, _plain_level_adjoint)
    assert torch.equal(ref_acc, g)
    assert [d.dtype for d in dmaps] == [dtype, dtype] and dw.dtype == dtype
    for lvl, (a, b) in enumerate(zip(dmaps, ref_maps)):
        _close(a, b.float(), GRAD_RTOL, f"coarse chain d level {levels[lvl]}")
    _close(dpts, ref_pts, GRAD_RTOL, "coarse chain d points")
    _close(dw, ref_w.float(), GRAD_RTOL, "coarse chain d weights")


@pytest.mark.parametrize("with_acc", [True, False])
def test_coarse_sample_function_wires_its_kernels(monkeypatch, with_acc):
    """K1's autograd Function on the CPU, with the plain version standing in
    for K1 and autograd of ``interp_matmul_camsum`` for K1-bwd: its forward
    is ``coarse_sample_plain``, its gradients (acc passed through, or none
    for ``acc=None``; maps, points, weights) are autograd's through it, and
    it calls K1 once and K1-bwd once per coarse level."""
    from hipad_torch.ops import kernels

    calls = {"k1": 0, "k1_bwd": 0}

    def k1(acc, maps, points, weights, levels):
        calls["k1"] += 1
        return tsam.coarse_sample_plain(acc, maps, points, weights, levels)

    def k1_bwd(*args):
        calls["k1_bwd"] += 1
        return _plain_level_adjoint(*args)

    monkeypatch.setattr(kernels, "coarse_sample", k1)
    monkeypatch.setattr(kernels, "interp_sample_camsum_bwd", k1_bwd)
    maps, pts, w, acc, g = _coarse_inputs(42, torch.float32)
    levels = (2, 3)
    ref_acc, ref_maps, ref_pts, ref_w = _coarse_plain_grads(maps, pts, w, acc, g, levels)
    lacc = acc.clone().requires_grad_() if with_acc else None
    lm = [m.clone().requires_grad_() for m in maps]
    lp, lw = pts.clone().requires_grad_(), w.clone().requires_grad_()
    out = tsam._CoarseSample.apply(lacc, lp, lw, levels, *lm)
    ref_out = tsam.coarse_sample_plain(lacc, maps, pts, w, levels)
    assert torch.equal(out, ref_out)
    got = torch.autograd.grad(out, ([lacc] if with_acc else []) + lm + [lp, lw], g)
    assert calls == {"k1": 1, "k1_bwd": len(levels)}
    if with_acc:
        assert torch.equal(got[0], g)
        got = got[1:]
    for lvl, (a, b) in enumerate(zip(got[:2], ref_maps)):
        _close(a, b, GRAD_RTOL, f"K1 Function d level {levels[lvl]}")
    _close(got[2], ref_pts, GRAD_RTOL, "K1 Function d points")
    _close(got[3], ref_w, GRAD_RTOL, "K1 Function d weights")


def test_hat_takes_the_jax_kink_conventions():
    """At a kink, ``hat`` differentiates as ``jnp.maximum(0, 1 - jnp.abs(t))``
    does: ``|t|' = 1`` at 0, half the gradient where ``1 - |t| = 0``."""
    t = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], np.float32)
    ref = jax.vmap(jax.grad(lambda v: jnp.maximum(0.0, 1.0 - jnp.abs(v))))(jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_()
    (got,) = torch.autograd.grad(tsam.hat(tt).sum(), tt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("config", ["stage2", "stage2_serving_det", "stage2_r101_2x", "tiny"])
def test_backward_bin_plans_fit_shared_memory(config):
    """K1-bwd's and K2-bwd's binned scatter on every coarse and fine level
    of the shipped configs, bs=1 and 2: the counts within 16 an item, the
    cells kernel's slices of a split cell (8 warps' fp32 partial sums of C
    channels) within the 48 KB a block takes without opting in, and a warp
    for each run of cells."""
    from hipad_torch.configs import model as configs
    from hipad_torch.ops import kernels

    cfg = getattr(configs, config)()
    H, W = cfg.input_size
    size = [(H // cfg.strides[l], W // cfg.strides[l]) for l in range(cfg.num_levels)]
    coarse = [l for l in cfg.sampler_matmul_levels if l < cfg.num_levels]
    fine = [size[l] for l in range(cfg.num_levels) if l not in coarse]
    n_det = cfg.num_det_anchor * (len(cfg.det_kps.fix_scale) + cfg.det_kps.num_learnable)
    for bs in (1, 2):
        B = bs * cfg.num_cams
        plans = [(kernels.k1_bwd_plan(B, *size[l], n_det), [size[l]]) for l in coarse]
        plans += [(kernels.k2_bwd_plan(bs, cfg.num_cams, fine, n_det * cfg.sampler_cam_k, n),
                   fine) for n in {len(fine), cfg.sampler_level_k or len(fine)}] if fine else []
        for plan, sizes in plans:
            assert plan.nbins * plan.chunks <= 16 * plan.items, plan
            assert plan.split == 1 or 8 * -(-cfg.embed_dims // 256) * 256 * 4 <= 48 * 1024, plan
            assert plan.ow in (1, 4), plan
            assert plan.warps == sum(B * h * -(-w // plan.ow) for h, w in sizes), plan


def test_binned_plan_takes_the_maps_the_tiles_refused():
    """The tiles of the first designs held map rows in one block's shared
    memory: a map of more than 7,264 cells went in bands of rows, and a row
    of more than 7,264 cells was refused. The binned scatter keeps no map in
    shared memory: one plan takes either, a warp for each run of cells."""
    from hipad_torch.ops import kernels

    for B, h, w in ((6, 8, 908), (6, 5, 1453), (1, 1, 7265)):
        plan = kernels.k1_bwd_plan(B, h, w, 11_700)
        assert plan.warps == B * h * -(-w // plan.ow), (h, w)
        assert plan.nbins * plan.chunks <= 16 * plan.items or plan.levels[0].sw >= w, (h, w)
