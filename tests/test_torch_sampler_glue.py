"""The sampler's glue around K1 and K2 on the CPU: the camera selection's
torch ops (``select_cameras_plain``, the plain version of
``kernels.cam_select``) against the selection the JAX package's
``deformable_samples_topk_flat`` hands its patch sampler, and the rule that
sends a call to the glue's kernels or to its torch ops
(``sampling.glue_on_card``).

The JAX side runs eagerly with its patch sampler and its coarse sampler
replaced by recorders, so only the selection is computed. The kernels
themselves run only on a card (``chip_smoke.py`` ``[kernels]``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipad_torch.ops import kernels
from hipad_torch.ops import sampling as tsam
from hipad_tpu.ops import sampling as jsam

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BS, M0, CAMS, G, C = 2, 24, 6, 4, 8
LEVEL_HW = ((6, 10), (3, 5), (2, 3), (2, 2))
MATMUL = (2, 3)
FINE = [0, 1]
# fp32 on both sides; the renormalisation's sums over 6 cameras add in
# another order: a few ulp of each weight
RENORM_RTOL = 1e-6


def _inputs(seed: int):
    """Points ``[BS, M0, CAMS, 2]``: sample 0 inside no camera, sample 1
    inside every camera, samples 2-3 with coordinates exactly 0.0 and 1.0
    (outside) beside ones just inside, the rest inside 0 to 4 cameras; and
    positive weights ``[BS, M0, CAMS, L, G]``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(1.05, 1.5, (BS, M0, CAMS, 2)) * rng.choice([-1.0, 1.0], (BS, M0, CAMS, 2))
    pts = np.where(pts < 0, pts + 1.0, pts)  # outside: (-0.5, -0.05) or (1.05, 1.5)
    for b in range(BS):
        for m in range(4, M0):
            cams = rng.permutation(CAMS)[: m % 5]
            pts[b, m, cams] = rng.uniform(0.01, 0.99, (len(cams), 2))
    pts[:, 1] = rng.uniform(0.01, 0.99, (BS, CAMS, 2))
    pts[:, 2] = rng.uniform(0.01, 0.99, (BS, CAMS, 2))
    pts[:, 2, ::2, 0] = 0.0
    pts[:, 2, 1::4, 1] = 1.0
    pts[:, 3] = rng.uniform(0.01, 0.99, (BS, CAMS, 2))
    pts[:, 3, 1::2, 1] = 1.0
    pts[:, 3, ::3, 0] = np.float32(1e-7)
    w = rng.uniform(0.01, 1.0, (BS, M0, CAMS, len(LEVEL_HW), G))
    return pts.astype(np.float32), w.astype(np.float32)


def _jax_selection(monkeypatch, pts, w, cam_k, renorm):
    """What JAX's ``deformable_samples_topk_flat`` hands ``patch_bilinear_w``
    for each fine level: (cam ``[BS, M]``, that level's weights ``[BS, M,
    G]``)."""
    seen = []

    def patch(feat, cam, sy, sx, wy, wx, wg):
        seen.append((np.asarray(cam), np.asarray(wg)))
        return jnp.zeros(cam.shape + (C,), jnp.float32)

    monkeypatch.setattr(jsam, "patch_bilinear_w", patch)
    monkeypatch.setattr(jsam, "interp_matmul_camsum",
                        lambda fm, px, py, w_lvl, groups, bs, cams:
                        jnp.zeros((bs, px.shape[1], fm.shape[-1]), jnp.float32))
    maps = [jnp.zeros((BS, CAMS, h, wd, C), jnp.float32) for h, wd in LEVEL_HW]
    jsam.deformable_samples_topk_flat(maps, jnp.asarray(pts), jnp.asarray(w), cam_k=cam_k,
                                      matmul_levels=MATMUL, cam_renorm=renorm)
    assert len(seen) == len(FINE)
    return seen


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("cam_k", [1, 2, CAMS])
def test_camera_selection_matches_jax(monkeypatch, cam_k, renorm):
    """The selection's torch ops against JAX's: each slot's camera (in-bounds
    cameras first, ties to the lowest index), its point, and each fine
    level's weights times the inside mask, renormalised where ``cam_k <
    cams``; with samples inside no camera, inside every camera and on the
    borders 0.0 and 1.0, which count as outside."""
    pts, w = _inputs(19 + cam_k)
    seen = _jax_selection(monkeypatch, pts, w, cam_k, renorm)
    cam, x, y, w_fine = tsam.select_cameras_plain(torch.from_numpy(pts), torch.from_numpy(w),
                                                  cam_k, renorm, FINE)
    M = M0 * cam_k
    assert cam.dtype == torch.int32 and cam.shape == (BS, M)
    assert x.dtype == y.dtype == w_fine.dtype == torch.float32
    assert w_fine.shape == (BS, M, len(FINE), G) and w_fine.is_contiguous()
    for f, (jcam, jw) in enumerate(seen):
        np.testing.assert_array_equal(cam.numpy(), jcam)
        if renorm and cam_k < CAMS:
            np.testing.assert_allclose(w_fine[:, :, f].numpy(), jw, rtol=RENORM_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(w_fine[:, :, f].numpy(), jw)
    at = cam.numpy().reshape(BS, M0, cam_k)[..., None]
    np.testing.assert_array_equal(x.numpy(), np.take_along_axis(pts[..., 0], at[..., 0], 2)
                                  .reshape(BS, M))
    np.testing.assert_array_equal(y.numpy(), np.take_along_axis(pts[..., 1], at[..., 0], 2)
                                  .reshape(BS, M))
    # the planted samples: none inside keeps cameras 0.. with zero weights;
    # every camera inside keeps cameras 0..cam_k-1 with their weights
    slots = cam.numpy().reshape(BS, M0, cam_k)
    assert (slots[:, 0] == np.arange(cam_k)).all() and (slots[:, 1] == np.arange(cam_k)).all()
    assert (w_fine.reshape(BS, M0, cam_k, len(FINE), G)[:, 0] == 0).all()
    inside = ((pts > 0) & (pts < 1)).all(-1)
    assert not inside[:, 2, ::2].any() and not inside[:, 3, 1::2].any()


def _recording_kernels(monkeypatch, calls):
    """The glue's kernels replaced by their torch ops, counted; K1 and K2 by
    zeros that carry their inputs' autograd."""
    def cam_select(points, weights, cam_k, renorm, fine):
        calls.append("cam_select")
        return tsam.select_cameras_plain(points, weights, cam_k, renorm, fine)

    def point_sum(flat, num_pts, dtype):
        calls.append("point_sum")
        return tsam.point_sum_plain(flat, num_pts, dtype)

    def patch(maps, cam, x, y, w, cam_k, lvl=None):
        return torch.zeros(x.shape[0], x.shape[1] // cam_k, C, device=x.device) + w.sum() * 0

    def coarse(acc, maps, points, weights, levels):
        zero = (points.float().sum() + weights.float().sum()) * 0
        return (acc if acc is not None else torch.zeros(points.shape[:2] + (C,),
                                                         device=points.device)) + zero

    monkeypatch.setattr(kernels, "cam_select", cam_select)
    monkeypatch.setattr(kernels, "point_sum", point_sum)
    monkeypatch.setattr(tsam, "patch_sample", patch)
    monkeypatch.setattr(tsam, "coarse_sample", coarse)


@pytest.mark.parametrize("case", ["cpu", "cpu_grad", "card", "card_grad", "card_grad_off"])
def test_glue_takes_its_kernels_only_on_a_card_without_gradient(monkeypatch, case):
    """``glue_on_card``: CPU tensors take the torch ops; off the CPU (meta
    tensors stand in for the card's here) the kernels run unless autograd
    wants the glue: inputs that need a gradient, with grad mode on."""
    calls = []
    _recording_kernels(monkeypatch, calls)
    dev = "cpu" if case.startswith("cpu") else "meta"
    pts, w = _inputs(7)
    pts = torch.from_numpy(pts).reshape(BS, 6, 4, CAMS, 2).to(dev)
    w = torch.from_numpy(w).reshape(BS, 6, 4, CAMS, len(LEVEL_HW), G).to(dev)
    grad = case.endswith(("_grad", "_grad_off"))
    pts.requires_grad_(grad)
    w.requires_grad_(grad)
    maps = [torch.zeros(BS, CAMS, h, wd, C, device=dev) for h, wd in LEVEL_HW]
    with torch.set_grad_enabled(case != "card_grad_off"):
        out = tsam.deformable_aggregation_topk(maps, pts, w, cam_k=2, matmul_levels=MATMUL,
                                               cam_renorm=True)
    assert out.shape == (BS, 6, C)
    kernels_ran = case in ("card", "card_grad_off")
    assert calls == (["cam_select", "point_sum"] if kernels_ran else [])
    assert out.requires_grad == (case in ("cpu_grad", "card_grad"))
