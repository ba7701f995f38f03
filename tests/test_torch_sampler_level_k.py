"""``sampler_level_k`` in the port against the JAX package on the CPU: the
plain level-k sampler (each camera-compacted sample reads only its
``level_k`` fine levels of largest mass, each from that level's own map)
against ``deformable_samples_topk_flat(level_k=...)``, which reads them from
one zero-padded combined pyramid; its gradients against ``jax.vjp``; the
exact case of ``tests/test_sampling.py``; ties; the autograd Function that
drives K2's and K2-bwd's level-k variants; and a two-frame episode at
``tiny(sampler_level_k=1)``.

Inputs are drawn with numpy from a seed; fp32 on both sides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.configs.model import tiny
from hipad_torch.ops import sampling as tsam
from hipad_tpu.ops import sampling as jsam
from test_torch_serve_model import _episode, assert_episode_matches

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# fp32 on both sides, sums over taps, slots and levels in another order
FP32_RTOL = 1e-5
# fp32 gradients summed in another order (as tests/test_torch_train_sampling.py)
GRAD_RTOL = 2e-5

BS, CAMS, C, G = 2, 3, 32, 4
LEVEL_HW = ((12, 20), (6, 10), (3, 5), (2, 3))  # two fine levels, two coarse


def _close(got, ref, rtol, what):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert scale > 0, what
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3e} > {rtol} x {scale:.3e}"


def _inputs(seed, m0=90):
    """Maps, points reaching past the unit square with some on level 0's
    pixel corners (the hat weights' kinks), and softmax weights in which
    every 5th sample puts all its fine mass on one level, every 7th has both
    fine levels at exactly the same mass (a tie) and every 11th none on
    either (a tie at 0)."""
    rng = np.random.default_rng(seed)
    maps = [rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32) for h, w in LEVEL_HW]
    pts = rng.uniform(-0.3, 1.3, (BS, m0, CAMS, 2)).astype(np.float32)
    h0, w0 = LEVEL_HW[0]
    pts[:, ::6, :, 0] = (np.round(pts[:, ::6, :, 0] * w0 - 0.5) + 0.5) / w0
    pts[:, ::9, :, 1] = (np.round(pts[:, ::9, :, 1] * h0 - 0.5) + 0.5) / h0
    logits = rng.standard_normal((BS, m0, CAMS * len(LEVEL_HW), G))
    w = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    w = w.reshape(BS, m0, CAMS, len(LEVEL_HW), G)
    w[:, ::5, :, rng.integers(0, 2)] = 0.0
    w[:, ::7, :, 1] = w[:, ::7, :, 0]
    w[:, ::11, :, :2] = 0.0
    return maps, pts, w.astype(np.float32)


@pytest.mark.parametrize("renorm", [True, False])
def test_level_k_sampler_and_grads_match_jax(renorm):
    """``deformable_samples_topk_flat`` at cam_k 2 with the camera
    renormalisation and ``level_k=1``, with and without the level
    renormalisation: the output, and the gradients to the four maps, the
    points and the weights against ``jax.vjp`` (through JAX's custom VJP of
    ``patch_bilinear_w`` on the combined pyramid)."""
    maps, pts, w = _inputs(41 + renorm)
    kw = dict(cam_k=2, matmul_levels=(2, 3), cam_renorm=True, level_k=1, level_renorm=renorm)
    g = np.random.default_rng(7).standard_normal((BS, pts.shape[1], C)).astype(np.float32)

    def jax_fn(maps, pts, w):
        return jsam.deformable_samples_topk_flat(maps, pts, w, **kw)

    ref, vjp = jax.vjp(jax_fn, [jnp.asarray(f) for f in maps], jnp.asarray(pts),
                       jnp.asarray(w))
    ref_maps, ref_pts, ref_w = vjp(jnp.asarray(g))
    lm = [torch.from_numpy(f).requires_grad_() for f in maps]
    lp, lw = (torch.from_numpy(a).requires_grad_() for a in (pts, w))
    out = tsam.deformable_samples_topk_flat(lm, lp, lw, **kw)
    _close(out, ref, FP32_RTOL, "level-k sampler")
    got = torch.autograd.grad(out, lm + [lp, lw], torch.from_numpy(g))
    for lvl, (a, b) in enumerate(zip(got[:4], ref_maps)):
        _close(a, b, GRAD_RTOL, f"level-k sampler d level {lvl}")
    _close(got[4], ref_pts, GRAD_RTOL, "level-k sampler d points")
    _close(got[5], ref_w, GRAD_RTOL, "level-k sampler d weights")


def test_level_k_exact_when_mass_covered():
    """The case of ``tests/test_sampling.py:362-420`` on the port: with each
    sample's weight on one fine level, ``level_k=1`` is the oracle exactly
    (and JAX's level-k sampler); with a small tail on the other level the
    renormalised result stays close; ``level_k`` equal to the number of fine
    levels is the sampler without it."""
    rng = np.random.RandomState(29)
    bs, cams, c, g, a, p = 1, 4, 32, 4, 5, 6
    shapes = [(16, 24), (8, 12), (4, 6)]  # two gather levels + one matmul
    feats = [rng.randn(bs, cams, h, w, c).astype(np.float32) for h, w in shapes]
    pts = rng.uniform(0.05, 0.95, (bs, a, p, cams, 2)).astype(np.float32)
    w = rng.rand(bs, a, p, cams, len(shapes), g).astype(np.float32)
    pick = rng.randint(0, 2, (a, p, cams))
    off = (1 - pick)[None, :, :, :, None, None] == np.arange(len(shapes))[:, None]
    w_sparse = np.where(off, 0.0, w).astype(np.float32)
    w_conc = np.where(off, 0.05 * w, w).astype(np.float32)
    tf = [torch.from_numpy(f) for f in feats]
    tp = torch.from_numpy(pts)

    def port(ww, **kw):
        return tsam.deformable_aggregation_topk(tf, tp, torch.from_numpy(ww), cam_k=cams,
                                                matmul_levels=(2,), **kw)

    oracle = tsam.deformable_aggregation(tf, tp, torch.from_numpy(w_sparse)).numpy()
    _close(port(w_sparse, level_k=1), oracle, FP32_RTOL, "level_k=1, one level per sample")
    ref = jsam.deformable_aggregation_topk([jnp.asarray(f) for f in feats], jnp.asarray(pts),
                                           jnp.asarray(w_sparse), cam_k=cams,
                                           matmul_levels=(2,), level_k=1)
    _close(port(w_sparse, level_k=1), ref, FP32_RTOL, "level_k=1 against JAX")

    ref_c = tsam.deformable_aggregation(tf, tp, torch.from_numpy(w_conc)).numpy()
    pr_c = port(w_conc, level_k=1).numpy()
    rel = np.abs(pr_c - ref_c).mean() / (np.abs(ref_c).mean() + 1e-9)
    assert rel < 0.12, rel

    _close(port(w, level_k=2), port(w).numpy(), FP32_RTOL, "level_k = fine levels")


def test_level_k_ties_go_to_the_lower_level():
    """Equal masses keep the lower fine level, as JAX's ``topk_by_argmax``
    picks it: the level indices and the kept, renormalised weights."""
    rng = np.random.default_rng(5)
    w = rng.uniform(0, 1, (BS, 40, 3, G)).astype(np.float32)
    w[:, ::2, 2] = w[:, ::2, 0]  # levels 0 and 2 tie
    w[:, ::3] = 0.0  # all three tie at 0
    w[:, 1::4, 1] = w[:, 1::4, 0]  # 0 and 1 tie
    kept, lidx = tsam._keep_top_levels(torch.from_numpy(w), 2, True)
    mass = jnp.asarray(w).sum(-1)
    ref_idx = np.asarray(jsam.topk_by_argmax(mass, 2))
    np.testing.assert_array_equal(lidx.numpy(), ref_idx)
    sel = np.take_along_axis(w, ref_idx[..., None], axis=2)
    ratio = w.sum(axis=2) / np.maximum(sel.sum(axis=2), 1e-9)
    _close(kept, sel * ratio[:, :, None], FP32_RTOL, "kept weights")


def test_patch_sample_function_wires_the_level_k_kernels(monkeypatch):
    """K2's autograd Function with ``lvl``, the plain version standing in for
    K2-lk and autograd of it for K2-bwd-lk: its forward is the plain
    version's, its gradients autograd's through it, and it calls each
    level-k kernel once and neither of the others."""
    from hipad_torch.ops import kernels

    calls = {}

    def stand_in(name, fn):
        def run(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return run

    def plain_bwd(maps, cam, x, y, w, gout, cam_k, lvl):
        leaves = [t.detach().requires_grad_() for t in (*maps, x, y, w)]
        with torch.enable_grad():  # a Function's backward runs without it
            out = tsam.patch_sample_plain(leaves[:len(maps)], cam, *leaves[len(maps):], cam_k,
                                          lvl)
            grads = torch.autograd.grad(out, leaves, gout)
        return list(grads[:len(maps)]), *grads[len(maps):]

    monkeypatch.setattr(kernels, "patch_sample_lk", stand_in("lk", tsam.patch_sample_plain))
    monkeypatch.setattr(kernels, "patch_sample_bwd_lk", stand_in("bwd_lk", plain_bwd))
    for name in ("patch_sample", "patch_sample_bwd"):
        monkeypatch.setattr(kernels, name, stand_in(name, None))
    rng = np.random.default_rng(9)
    cam_k, m0 = 2, 60
    maps = [torch.from_numpy(rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32))
            for h, w in LEVEL_HW[:2]]
    cam = torch.from_numpy(rng.integers(0, CAMS, (BS, m0 * cam_k)).astype(np.int32))
    x, y = (torch.from_numpy(rng.uniform(-0.1, 1.1, (BS, m0 * cam_k)).astype(np.float32))
            for _ in range(2))
    lvl = torch.from_numpy(rng.integers(0, 2, (BS, m0 * cam_k, 1)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, (BS, m0 * cam_k, 1, G)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((BS, m0, C)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (*maps, x, y, w)]
    out = tsam._PatchSample.apply(cam, *leaves[2:], lvl, cam_k, *leaves[:2])
    ref_leaves = [t.clone().requires_grad_() for t in (*maps, x, y, w)]
    ref = tsam.patch_sample_plain(ref_leaves[:2], cam, *ref_leaves[2:], cam_k, lvl)
    assert torch.equal(out, ref)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(ref, ref_leaves, g)
    assert calls == {"lk": 1, "bwd_lk": 1}
    for name, a, b in zip(("d level 0", "d level 1", "dx", "dy", "dw"), got, want):
        _close(a, b.numpy(), GRAD_RTOL, f"K2-lk Function {name}")


def test_level_k_reads_only_the_kept_levels():
    """The plain level-k version equals the plain all-levels version whose
    weights are zero but on each sample's kept level: one level's own map,
    clip caps and hat weights."""
    rng = np.random.default_rng(13)
    cam_k, m = 2, 200
    maps = [torch.from_numpy(rng.standard_normal((BS, CAMS, h, w, C)).astype(np.float32))
            for h, w in LEVEL_HW[:2]]
    cam = torch.from_numpy(rng.integers(0, CAMS, (BS, m)).astype(np.int32))
    x, y = (torch.from_numpy(rng.uniform(-0.2, 1.2, (BS, m)).astype(np.float32))
            for _ in range(2))
    lvl = torch.from_numpy(rng.integers(0, 2, (BS, m, 1)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0, 1, (BS, m, 1, G)).astype(np.float32))
    w_all = torch.zeros(BS, m, 2, G).scatter(2, lvl.long()[..., None].expand(-1, -1, -1, G), w)
    _close(tsam.patch_sample_plain(maps, cam, x, y, w, cam_k, lvl),
           tsam.patch_sample_plain(maps, cam, x, y, w_all, cam_k).numpy(), FP32_RTOL,
           "level-k against zeroed levels")


def test_level_k_episode_matches_jax():
    """Two frames of ``tiny(sampler_level_k=1)``: every output stack and
    bank tensor, as the serving knobs' episodes hold them."""
    cfg = tiny(decoder_remat=False, sampler_level_k=1)
    assert_episode_matches(_episode(cfg))
