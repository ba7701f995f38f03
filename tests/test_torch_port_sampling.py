"""The port's sampler (plain PyTorch paths of kernels K1 and K2, the stage-2
sampler and the oracle) against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages; all
comparisons are fp32 unless stated. The Pallas kernel itself runs in
interpret mode through a proxy for its module's ``pl`` (no JAX file changes).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_tpu.ops import pallas_interp
from hipad_tpu.ops import sampling as jsam
from hipad_torch.ops import sampling as tsam

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# fp32 on both sides, sums over <= 4 taps x cameras x levels in another
# order: a few ulp of the largest value.
FP32_RTOL = 1e-5

# small shapes shared by every case (one set of JAX programs)
BS, CAMS, C, G = 2, 4, 32, 4
LEVEL_HW = ((12, 20), (6, 10), (3, 5), (2, 3))


def _assert_close(got: torch.Tensor, ref, rtol: float, what: str):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert err <= rtol * scale, f"{what}: max_abs_err {err:.3e} > {rtol} x {scale:.3e}"


def _maps(rng, dtype=np.float32):
    return [rng.standard_normal((BS, CAMS, h, w, C)).astype(dtype) for h, w in LEVEL_HW]


def _points(rng, m0):
    """[BS, m0, CAMS, 2] points, each inside exactly 0, 1, 2 or 3 cameras
    (cycling), the others outside the unit square; plus the weights."""
    pts = rng.uniform(1.02, 1.6, (BS, m0, CAMS, 2)) * rng.choice([-1.0, 1.0], (BS, m0, CAMS, 2))
    pts = np.where(pts < 0, pts + 1.0, pts)  # outside: (-0.6, -0.02) or (1.02, 1.6)
    for b in range(BS):
        for m in range(m0):
            cams = rng.permutation(CAMS)[: m % 4]
            pts[b, m, cams] = rng.uniform(0.01, 0.99, (len(cams), 2))
    logits = rng.standard_normal((BS, m0, CAMS * len(LEVEL_HW), G))
    w = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    return (pts.astype(np.float32),
            w.reshape(BS, m0, CAMS, len(LEVEL_HW), G).astype(np.float32))


def _interp_inputs(rng, dtype):
    h, w, m = 6, 10, 300
    fm = rng.standard_normal((BS * CAMS, h, w, C)).astype(np.float32)
    if dtype == "bf16":
        fm = np.array(jnp.asarray(fm, jnp.bfloat16).astype(jnp.float32))
    # pixel coordinates reaching past every border (corners out of bounds)
    px = rng.uniform(-1.5, w + 0.5, (BS * CAMS, m)).astype(np.float32)
    py = rng.uniform(-1.5, h + 0.5, (BS * CAMS, m)).astype(np.float32)
    wg = rng.uniform(0, 1, (BS * CAMS, m, G)).astype(np.float32)
    wg *= (rng.uniform(size=(BS * CAMS, m, 1)) < 0.7)
    return fm, px, py, wg


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_interp_sample_camsum_plain_matches_jax(dtype):
    """One coarse level of K1's plain version (``interp_matmul_camsum``, which
    ``coarse_sample_plain`` sums over the levels) against the JAX package's
    ``interp_matmul_camsum``. bf16: JAX rounds the interpolation weights to
    bf16 before its product (relative error <= 2^-8 per weight), the port
    keeps them fp32, so 1e-2 of the largest value."""
    rng = np.random.default_rng(1)
    fm, px, py, wg = _interp_inputs(rng, dtype)
    jfm = jnp.asarray(fm, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = jsam.interp_matmul_camsum(jfm, jnp.asarray(px), jnp.asarray(py),
                                    jnp.asarray(wg), G, BS, CAMS)
    tfm = torch.from_numpy(fm).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    got = tsam.interp_matmul_camsum(tfm, torch.from_numpy(px), torch.from_numpy(py),
                                    torch.from_numpy(wg), BS, CAMS)
    _assert_close(got, ref, FP32_RTOL if dtype == "fp32" else 1e-2, "interp_sample_camsum")


class _InterpretPallas:
    """Stands in for ``jax.experimental.pallas`` inside pallas_interp: every
    ``pallas_call`` runs in interpret mode on the CPU."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


def test_pallas_kernel_interpret_matches_port(monkeypatch):
    """The TPU kernel ``interp_matmul_pallas`` itself (interpret mode), its
    padded [B, Mp, C] output sliced to M and summed over cameras, against
    the port's plain K1. bf16 feature map, as the kernel takes it; the kernel
    also feeds bf16 interpolation weights to its product: 1e-2 of the
    largest value."""
    monkeypatch.setattr(pallas_interp, "pl", _InterpretPallas(pallas_interp.pl))
    rng = np.random.default_rng(2)
    fm, px, py, wg = _interp_inputs(rng, "bf16")
    m = px.shape[1]
    out = pallas_interp.interp_matmul_pallas(
        jnp.asarray(fm, jnp.bfloat16), jnp.asarray(px), jnp.asarray(py), jnp.asarray(wg), G)
    out = np.asarray(out, np.float32)
    assert out.shape[1] % pallas_interp.TILE == 0 and out.shape[1] >= m
    ref = out[:, :m].reshape(BS, CAMS, m, C).sum(axis=1)
    got = tsam.interp_matmul_camsum(torch.from_numpy(fm).to(torch.bfloat16),
                                    torch.from_numpy(px), torch.from_numpy(py),
                                    torch.from_numpy(wg), BS, CAMS)
    _assert_close(got, ref, 1e-2, "interp_matmul_pallas (interpret)")


def test_patch_sample_plain_matches_jax():
    """K2's plain version against JAX's ``patch_bilinear_w`` per fine level,
    summed over the cam_k slots and the levels, with locations reaching past
    every border (clamped patch origins)."""
    rng = np.random.default_rng(3)
    cam_k, m0 = 2, 150
    m = m0 * cam_k
    maps = _maps(rng)[:2]
    cam = rng.integers(0, CAMS, (BS, m)).astype(np.int32)
    x = rng.uniform(-0.1, 1.1, (BS, m)).astype(np.float32)
    y = rng.uniform(-0.1, 1.1, (BS, m)).astype(np.float32)
    w = rng.uniform(0, 1, (BS, m, 2, G)).astype(np.float32)

    ref = 0.0
    two = jnp.arange(2, dtype=jnp.float32)
    for lvl, feat in enumerate(maps):
        h, wl = feat.shape[2:4]
        px, py = jnp.asarray(x) * wl - 0.5, jnp.asarray(y) * h - 0.5
        sy = jnp.clip(jnp.floor(py), 0, h - 2).astype(jnp.int32)
        sx = jnp.clip(jnp.floor(px), 0, wl - 2).astype(jnp.int32)
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(py[..., None] - (sy[..., None] + two)))
        wx = jnp.maximum(0.0, 1.0 - jnp.abs(px[..., None] - (sx[..., None] + two)))
        s = jsam.patch_bilinear_w(jnp.asarray(feat), jnp.asarray(cam), sy, sx, wy, wx,
                                  jnp.asarray(w[:, :, lvl]))
        ref = ref + np.asarray(s).reshape(BS, m0, cam_k, C).sum(axis=2)
    got = tsam.patch_sample([torch.from_numpy(f) for f in maps], torch.from_numpy(cam),
                            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                            cam_k)
    _assert_close(got, ref, FP32_RTOL, "patch_sample")


def _coarse_inputs(rng, m0=120):
    """Coarse maps of levels 2-3, ``[BS, m0, CAMS, 2]`` points reaching past
    the unit square (outside: masked), a few exactly on its borders 0 and 1
    (outside too), and every 7th on level 2's pixel centres (integer pixel
    coordinates: the hat weights' kinks), the weights of all 4 levels and an
    acc."""
    maps = _maps(rng)[2:]
    pts = rng.uniform(-0.3, 1.3, (BS, m0, CAMS, 2)).astype(np.float32)
    h2, w2 = LEVEL_HW[2]
    pts[:, ::7, :, 0] = (rng.integers(0, w2, (BS, len(range(0, m0, 7)), CAMS)) + 0.5) / w2
    pts[:, ::7, :, 1] = (rng.integers(0, h2, (BS, len(range(0, m0, 7)), CAMS)) + 0.5) / h2
    pts[0, 1, :, 0] = (0.0, 1.0, 0.5, 0.5)[:CAMS]
    w = rng.uniform(0, 1, (BS, m0, CAMS, len(LEVEL_HW), G)).astype(np.float32)
    acc = rng.standard_normal((BS, m0, C)).astype(np.float32)
    return maps, pts.astype(np.float32), w, acc


def _jax_coarse_loop(acc, maps, pts, w, levels):
    """The JAX package's coarse-level loop of ``deformable_samples_topk_flat``
    (``hipad_tpu/ops/sampling.py:849-870``) on its own: camera-major
    coordinates, weights times the inside mask, then ``interp_matmul_camsum``
    of each level added to ``acc`` in turn."""
    bs, m0, cams, _ = pts.shape
    num_levels, groups = w.shape[-2:]
    inside = jnp.all((pts > 0.0) & (pts < 1.0), axis=-1)
    bfull = bs * cams
    xf = jnp.transpose(pts[..., 0], (0, 2, 1)).reshape(bfull, m0)
    yf = jnp.transpose(pts[..., 1], (0, 2, 1)).reshape(bfull, m0)
    insf = jnp.transpose(inside, (0, 2, 1)).reshape(bfull, m0)
    wf = jnp.transpose(w, (0, 2, 1, 3, 4)).reshape(
        bfull, m0, num_levels, groups) * insf[..., None, None]
    out = jnp.zeros((bs, m0, C), jnp.float32) if acc is None else acc
    for lvl, feat in zip(levels, maps):
        h_l, w_l = feat.shape[2], feat.shape[3]
        contrib = jsam.interp_matmul_camsum(feat.reshape(bfull, h_l, w_l, C), xf * w_l - 0.5,
                                            yf * h_l - 0.5, wf[:, :, lvl], groups, bs, cams)
        out = out + contrib.astype(out.dtype)
    return out


@pytest.mark.parametrize("with_acc", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_coarse_sample_plain_matches_jax(dtype, with_acc):
    """K1's plain version (``coarse_sample_plain``, the CPU path of
    ``coarse_sample``) against the JAX package's coarse loop, with and
    without acc. bf16: the port takes bf16 maps and weights and reads them
    into fp32; JAX gets the same values as fp32 maps (its bf16 path rounds
    the interpolation weights to bf16) and the bf16 weights, which it
    multiplies in fp32 too."""
    rng = np.random.default_rng(9)
    maps, pts, w, acc = _coarse_inputs(rng)
    levels = (2, 3)
    if dtype == "bf16":
        maps = [np.array(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)) for f in maps]
        jw = jnp.asarray(w, jnp.bfloat16)
        tmaps = [torch.from_numpy(f).to(torch.bfloat16) for f in maps]
        tw = torch.from_numpy(w).to(torch.bfloat16)
    else:
        jw, tmaps, tw = jnp.asarray(w), [torch.from_numpy(f) for f in maps], torch.from_numpy(w)
    ref = _jax_coarse_loop(jnp.asarray(acc) if with_acc else None,
                           [jnp.asarray(f) for f in maps], jnp.asarray(pts), jw, levels)
    got = tsam.coarse_sample(torch.from_numpy(acc) if with_acc else None, tmaps,
                             torch.from_numpy(pts), tw, levels)
    assert got.dtype == torch.float32
    _assert_close(got, ref, FP32_RTOL, f"coarse_sample {dtype} acc={with_acc}")


def test_coarse_loop_copy_is_the_packages():
    """The test's copy of the JAX coarse loop is the package's: with zero
    fine maps, ``deformable_samples_topk_flat`` returns the coarse levels'
    sum alone, which ``coarse_sample_plain`` (no acc) matches too."""
    rng = np.random.default_rng(10)
    maps, pts, w, _ = _coarse_inputs(rng)
    full = [np.zeros((BS, CAMS, h, wd, C), np.float32) for h, wd in LEVEL_HW[:2]] + maps
    ref = jsam.deformable_samples_topk_flat([jnp.asarray(f) for f in full], jnp.asarray(pts),
                                            jnp.asarray(w), cam_k=2, matmul_levels=(2, 3))
    copy = _jax_coarse_loop(None, [jnp.asarray(f) for f in maps], jnp.asarray(pts),
                            jnp.asarray(w), (2, 3))
    _assert_close(torch.from_numpy(np.array(copy)), ref, FP32_RTOL, "coarse loop copy")
    got = tsam.coarse_sample_plain(None, [torch.from_numpy(f) for f in maps],
                                   torch.from_numpy(pts), torch.from_numpy(w), (2, 3))
    _assert_close(got, ref, FP32_RTOL, "coarse_sample_plain vs topk_flat")


@pytest.mark.parametrize("cam_renorm", [True, False])
def test_topk_flat_matches_jax(cam_renorm):
    """``deformable_samples_topk_flat`` at stage-2 form (cam_k=2,
    matmul_levels=(2, 3)) with points inside 0, 1, 2 and 3 of 4 cameras:
    the 3-camera points exercise the tie-breaking camera top-k and the
    renormalisation."""
    rng = np.random.default_rng(4)
    maps = _maps(rng)
    pts, w = _points(rng, 64)
    ref = jsam.deformable_samples_topk_flat(
        [jnp.asarray(f) for f in maps], jnp.asarray(pts), jnp.asarray(w), cam_k=2,
        matmul_levels=(2, 3), cam_renorm=cam_renorm)
    got = tsam.deformable_samples_topk_flat(
        [torch.from_numpy(f) for f in maps], torch.from_numpy(pts), torch.from_numpy(w),
        cam_k=2, matmul_levels=(2, 3), cam_renorm=cam_renorm)
    _assert_close(got, ref, FP32_RTOL, "deformable_samples_topk_flat")


def _anchor_inputs(rng):
    maps = _maps(rng)
    pts, w = _points(rng, 48)  # 12 anchors x 4 points
    return (maps, pts.reshape(BS, 12, 4, CAMS, 2),
            w.reshape(BS, 12, 4, CAMS, len(LEVEL_HW), G))


def test_deformable_aggregation_topk_matches_jax():
    """The whole stage-2 sampler, summed over each anchor's points."""
    maps, pts, w = _anchor_inputs(np.random.default_rng(5))
    ref = jsam.deformable_aggregation_topk(
        [jnp.asarray(f) for f in maps], jnp.asarray(pts), jnp.asarray(w), cam_k=2,
        matmul_levels=(2, 3), cam_renorm=True)
    got = tsam.deformable_aggregation_topk(
        [torch.from_numpy(f) for f in maps], torch.from_numpy(pts), torch.from_numpy(w),
        cam_k=2, matmul_levels=(2, 3), cam_renorm=True)
    _assert_close(got, ref, FP32_RTOL, "deformable_aggregation_topk")


def test_deformable_aggregation_oracle_matches_jax():
    """The exact oracle (four corner gathers per sample, camera and level)."""
    maps, pts, w = _anchor_inputs(np.random.default_rng(6))
    ref = jsam.deformable_aggregation([jnp.asarray(f) for f in maps], jnp.asarray(pts),
                                      jnp.asarray(w))
    got = tsam.deformable_aggregation([torch.from_numpy(f) for f in maps],
                                      torch.from_numpy(pts), torch.from_numpy(w))
    _assert_close(got, ref, FP32_RTOL, "deformable_aggregation")


def test_topk_with_all_cameras_equals_oracle():
    """Keeping every camera, the hybrid sampler (patch gathers on levels 0-1,
    dense interp on 2-3) is the oracle's function: no JAX needed."""
    maps, pts, w = _anchor_inputs(np.random.default_rng(7))
    tm = [torch.from_numpy(f) for f in maps]
    tp, tw = torch.from_numpy(pts), torch.from_numpy(w)
    _assert_close(tsam.deformable_aggregation_topk(tm, tp, tw, cam_k=CAMS),
                  tsam.deformable_aggregation(tm, tp, tw).numpy(), FP32_RTOL,
                  "topk(cam_k=cams) vs oracle")


def test_front_view_feature():
    maps = _maps(np.random.default_rng(8))
    ref = jsam.front_view_feature([jnp.asarray(f) for f in maps])
    got = tsam.front_view_feature([torch.from_numpy(f) for f in maps])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reference_route_is_the_oracle_at_tiny():
    """``sampler="reference"`` runs the oracle on the CPU and, on the card,
    the topk sampler with every camera kept and no renormalisation (K2 on
    the fine levels, K1 on the coarse ones). The two plain forms are one
    function at ``tiny()``'s widths (2 cameras, C 32, G 4, the 64x96 input's
    four levels), with points exactly on the image borders 0 and 1 and just
    outside them (both masked), just inside, and on pixel edges and centres
    of every level (the hat weights' kinks, and corners that fall off the
    map)."""
    from hipad_torch.configs.model import tiny

    cfg = tiny()
    rng = np.random.default_rng(11)
    H, W = cfg.input_size
    maps = [torch.from_numpy(rng.standard_normal(
        (BS, cfg.num_cams, H // s, W // s, cfg.embed_dims)).astype(np.float32))
        for s in cfg.strides]
    n, p = 30, 13
    pts = rng.uniform(-0.2, 1.2, (BS, n, p, cfg.num_cams, 2)).astype(np.float32)
    special = np.array([0.0, 1.0, -1e-6, 1.0 + 1e-6, 1e-6, 1.0 - 1e-6], np.float32)
    pts[:, ::3, 0, :, 0] = rng.choice(special, (BS, 10, cfg.num_cams))
    pts[:, 1::3, 1, :, 1] = rng.choice(special, (BS, 10, cfg.num_cams))
    for i, s in enumerate(cfg.strides):  # pixel edges (k / w) and centres
        w = W // s
        k = rng.integers(0, w + 1, (BS, n, cfg.num_cams))
        pts[:, :, 2 + 2 * i, :, 0] = (k + 0.5 * (i % 2)) / w
        pts[:, :, 3 + 2 * i, :, 1] = rng.integers(0, H // s + 1, (BS, n, cfg.num_cams)) / (H // s)
    w = rng.uniform(0, 1, (BS, n, p, cfg.num_cams, cfg.num_levels, cfg.num_groups))
    tp, tw = torch.from_numpy(pts), torch.from_numpy(w.astype(np.float32))
    inside = ((pts > 0) & (pts < 1)).all(-1)
    assert inside.any() and not inside.all()
    ref = tsam.deformable_aggregation(maps, tp, tw)
    got = tsam.deformable_aggregation_topk(maps, tp, tw, cam_k=cfg.num_cams,
                                           matmul_levels=cfg.sampler_matmul_levels,
                                           cam_renorm=False)
    _assert_close(got, ref.numpy(), FP32_RTOL, "topk(cam_k=cams, no renorm) vs oracle at tiny")
