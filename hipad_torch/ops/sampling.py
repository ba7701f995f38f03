"""Multi-camera multi-scale deformable sampling: plain PyTorch versions and
the dispatch to the CUDA kernels.

Counterpart of ``hipad_tpu/ops/sampling.py``: the oracle, the camera top-k
sampler with its renormalisation and the level top-k of
``sampler_level_k``; not the row-packed gathers (``sampler_row_packed``).
For every (anchor, keypoint, camera, level) the sampler reads a bilinear
sample of an NHWC feature pyramid at a normalised 2D location, multiplies it
by a per-(point, camera, level, group) weight and sums into a per-anchor
feature.

Layouts are the JAX package's: feature maps ``[bs, cams, H, W, C]``, points
``[bs, n, P, cams, 2]`` in (x, y) order, weights ``[bs, n, P, cams, L, G]``
with channels split into ``G`` contiguous groups.

Two functions dispatch by device and by nothing else:

  * :func:`coarse_sample` (every coarse level, counterpart of the Pallas
    kernel ``interp_matmul_pallas`` plus the camera sum and the coarse-level
    loop of ``deformable_samples_topk_flat``) -> kernel K1, one launch for
    all coarse levels, with K1-bwd (one launch per level) as its gradient;
  * :func:`patch_sample` (fine levels, counterpart of ``patch_bilinear_w`` as
    driven by ``deformable_samples_topk_flat``) -> kernel K2, with K2-bwd as
    its gradient; with ``lvl`` (each sample's kept fine levels under
    ``sampler_level_k``) their level-k variants.

A CPU tensor takes the plain version beside each, and autograd through it
gives the gradient; a CUDA tensor takes the kernels in ``ops/kernels.py``
through a ``torch.autograd.Function``, and they raise on anything they do
not take. Gradients reach the feature maps, the continuous coordinates and
the group weights, as the JAX package's adjoints do: the coordinates
through the hat weights (:func:`hat`), never through an integer patch
origin.

The glue around them, the camera selection before K2
(:func:`select_cameras_plain`) and the point sum after K1
(:func:`point_sum_plain`), runs as two kernels of its own
(``kernels.cam_select``, ``kernels.point_sum``, whose fp32 sums add in a
fixed order of their own, so they differ from the torch ops by rounding)
where the tensors are on a card and autograd needs nothing of them
(:func:`glue_on_card`), and as those torch ops everywhere else.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from ..utils.spans import span
from . import kernels, ranking


def _autocast_off(fn):
    """Run a plain version with autocast off on both devices: like its
    kernel it computes in fp32 whatever autocast says (the CPU's autocast
    would take its einsums and products in bf16)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autocast("cpu", enabled=False), torch.autocast("cuda", enabled=False):
            return fn(*args, **kwargs)

    return wrapped


def hat(t: torch.Tensor) -> torch.Tensor:
    """The bilinear hat weight ``max(0, 1 - |t|)``, written so that autograd
    takes the JAX package's conventions at the kinks: ``|t|' = 1`` at 0
    (``torch.abs`` gives 0) and ``max(0, u)`` passes half the gradient at
    ``u = 0`` (``torch.clamp`` passes all of it). The kernels' backward does
    the same (``csrc/sample_common.cuh``)."""
    return torch.maximum(1.0 - torch.where(t >= 0, t, -t), torch.zeros((), device=t.device))


def _inside(points_2d: torch.Tensor) -> torch.Tensor:
    """Samples strictly inside the open unit square (the reference's bounds
    check); the last axis holds (x, y)."""
    return ((points_2d > 0.0) & (points_2d < 1.0)).all(dim=-1)


@_autocast_off
def deformable_aggregation(
    feature_maps: Sequence[torch.Tensor],
    points_2d: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Exact oracle: four corner row gathers per (sample, camera, level).

    Samples outside the open unit square get weight zero, and each bilinear
    corner outside the map contributes zero. Returns ``[bs, anchor, C]`` in
    the weights' dtype.
    """
    bs, num_anchor, num_pts, num_cams, _ = points_2d.shape
    channels = feature_maps[0].shape[-1]
    groups = weights.shape[-1]
    group_dims = channels // groups

    inside = _inside(points_2d).permute(0, 3, 1, 2)  # [b, c, a, p]
    x = points_2d[..., 0].permute(0, 3, 1, 2)
    y = points_2d[..., 1].permute(0, 3, 1, 2)
    w = weights.permute(0, 3, 1, 2, 4, 5)  # [b, c, a, p, L, G]

    out = torch.zeros(bs, num_anchor, channels, dtype=weights.dtype,
                      device=weights.device)
    for lvl, feat in enumerate(feature_maps):
        h_l, w_l = feat.shape[2], feat.shape[3]
        fm = feat.reshape(bs * num_cams, h_l * w_l, channels)
        px = x * w_l - 0.5
        py = y * h_l - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        x0 = x0.long()
        y0 = y0.long()
        w_lvl = w[..., lvl, :] * inside[..., None]  # [b, c, a, p, G]
        for dy, dx, cw in (
            (0, 0, (1.0 - fy) * (1.0 - fx)),
            (0, 1, (1.0 - fy) * fx),
            (1, 0, fy * (1.0 - fx)),
            (1, 1, fy * fx),
        ):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < w_l) & (yi >= 0) & (yi < h_l)
            idx = yi.clamp(0, h_l - 1) * w_l + xi.clamp(0, w_l - 1)
            idx = idx.reshape(bs * num_cams, num_anchor * num_pts, 1)
            gathered = torch.gather(fm, 1, idx.expand(-1, -1, channels))
            gathered = gathered.reshape(bs, num_cams, num_anchor, num_pts,
                                        groups, group_dims)
            corner_w = (cw * valid).to(weights.dtype)[..., None] * w_lvl
            out = out + torch.einsum(
                "bcapgd,bcapg->bagd", gathered.to(weights.dtype), corner_w
            ).reshape(bs, num_anchor, channels)
    return out


def interp_matmul_level(
    fm: torch.Tensor,  # [B, H, W, C]
    px: torch.Tensor,  # [B, M] continuous pixel x
    py: torch.Tensor,
    wg: torch.Tensor,  # [B, M, G] group weights (0 for out-of-bounds samples)
    groups: int,
) -> torch.Tensor:
    """Bilinear sampling of one level as a dense ``[M, H*W] x [H*W, C]``
    product with separable hat weights ``max(0, 1 - |p - iota|)``: corners
    out of bounds get weight zero. Returns ``[B, M, G, C/G]``, already
    multiplied by ``wg``. The product runs in float32 whatever the map's
    dtype (the kernel, K1, also reads bf16 maps into float32)."""
    B, H, W, C = fm.shape
    M = px.shape[1]
    iota_h = torch.arange(H, dtype=torch.float32, device=fm.device)
    iota_w = torch.arange(W, dtype=torch.float32, device=fm.device)
    wy = hat(py.float()[..., None] - iota_h)
    wx = hat(px.float()[..., None] - iota_w)
    interp = (wy[..., :, None] * wx[..., None, :]).reshape(B, M, H * W)
    out = torch.bmm(interp, fm.reshape(B, H * W, C).float())
    return out.reshape(B, M, groups, C // groups) * wg.float()[..., None]


@_autocast_off
def interp_matmul_camsum(fm, px, py, wg, bs: int, cams: int) -> torch.Tensor:
    """One coarse level of K1's plain version (:func:`coarse_sample_plain`
    sums it over the levels): :func:`interp_matmul_level` summed over the
    camera axis -> ``[bs, M, C]`` float32. ``fm`` is ``[bs*cams, H, W, C]``,
    ``px, py`` are ``[bs*cams, M]`` pixel coordinates, ``wg [bs*cams, M, G]``."""
    B, M = px.shape
    C = fm.shape[-1]
    c = interp_matmul_level(fm, px, py, wg, wg.shape[-1])
    return c.reshape(bs, cams, M, C).sum(dim=1)


@_autocast_off
def patch_sample_plain(
    fine_maps: Sequence[torch.Tensor],
    cam: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    cam_k: int,
    lvl=None,
) -> torch.Tensor:
    """Plain version of K2 (and, given ``lvl``, of its level-k variant):
    fine-level patch sampling of camera-compacted samples, summed over the
    ``cam_k`` slots and the fine levels.

    Args:
      fine_maps: per-level ``[bs, cams, H, W, C]`` maps (H, W >= 2).
      cam: ``[bs, M]`` int camera of each compacted sample, ``M = M0*cam_k``
        with the slot index fastest.
      x, y: ``[bs, M]`` normalised locations.
      w: ``[bs, M, len(fine_maps), G]`` group weights carrying the inside
        mask and the camera renormalisation; with ``lvl``, ``[bs, M,
        level_k, G]``, the weights of each sample's kept levels.
      lvl: None, or ``[bs, M, level_k]`` int indices into ``fine_maps``:
        slot ``j`` of a sample reads level ``lvl[..., j]`` only.

    Each sample reads one ``(2, 2, C)`` patch per level whose origin is
    clamped to ``[0, H-2] x [0, W-2]`` of that level; the hat weights
    ``max(0, 1 - |p - origin - i|)`` taken against the clamped origin give
    corners out of bounds weight zero. Returns ``[bs, M0, C]`` float32.
    """
    bs, M = cam.shape
    C = fine_maps[0].shape[-1]
    G = w.shape[-1]
    two = torch.arange(2, dtype=torch.float32, device=x.device)
    cam = cam.long()
    out = torch.zeros(bs, M, C, dtype=torch.float32, device=x.device)
    sampled_at = []  # [bs, M, G, C/G] per level, unweighted
    for feat in fine_maps:
        cams, h_l, w_l = feat.shape[1:4]
        px = x.float() * w_l - 0.5
        py = y.float() * h_l - 0.5
        sy = torch.floor(py).clamp(0, h_l - 2)
        sx = torch.floor(px).clamp(0, w_l - 2)
        wy = hat(py[..., None] - (sy[..., None] + two))
        wx = hat(px[..., None] - (sx[..., None] + two))
        row = (cam * h_l + sy.long()) * w_l + sx.long()  # [bs, M] top-left cell
        # 0, 1, w_l, w_l + 1, made on the device (a tensor from a list would
        # be a host-to-device copy, which waits for the queue)
        offs = (torch.arange(2, device=x.device)[:, None] * w_l
                + torch.arange(2, device=x.device)).reshape(4)
        idx = (row[..., None] + offs).reshape(bs, M * 4, 1)
        patch = torch.gather(feat.reshape(bs, cams * h_l * w_l, C), 1,
                             idx.expand(-1, -1, C)).reshape(bs, M, 4, C).float()
        w4 = (wy[..., :, None] * wx[..., None, :]).reshape(bs, M, 4)
        sampled_at.append(torch.einsum("bmqc,bmq->bmc", patch, w4).reshape(bs, M, G, C // G))
    # (level, its group weights): every level with its own weights, or, with
    # lvl, each kept slot's weights on the level it names and zero elsewhere
    if lvl is None:
        terms = [(l, w[:, :, l].float()) for l in range(len(fine_maps))]
    else:
        lvl = lvl.long()
        terms = [(l, w[:, :, j].float() * (lvl[..., j] == l)[..., None])
                 for j in range(lvl.shape[-1]) for l in range(len(fine_maps))]
    for l, wl in terms:
        out = out + (sampled_at[l] * wl[..., None]).reshape(bs, M, C)
    return out.reshape(bs, M // cam_k, cam_k, C).sum(dim=2)


class _PatchSample(torch.autograd.Function):
    """K2 forward, K2-bwd backward, or with ``lvl`` their level-k variants;
    the maps ride last in ``*maps``. The chain from the kept levels' weights
    back through the level selection and its renormalisation is autograd's
    (:func:`_keep_top_levels`)."""

    @staticmethod
    def forward(ctx, cam, x, y, w, lvl, cam_k: int, *maps):
        ctx.save_for_backward(cam, x, y, w, *maps)
        ctx.cam_k, ctx.lvl = cam_k, lvl
        if lvl is None:
            return kernels.patch_sample(list(maps), cam, x, y, w, cam_k)
        return kernels.patch_sample_lk(list(maps), cam, x, y, w, cam_k, lvl)

    @staticmethod
    def backward(ctx, gout):
        cam, x, y, w, *maps = ctx.saved_tensors
        bwd = kernels.patch_sample_bwd if ctx.lvl is None else kernels.patch_sample_bwd_lk
        dmaps, dx, dy, dw = bwd(maps, cam, x, y, w, gout.float().contiguous(), ctx.cam_k,
                                ctx.lvl)
        return (None, dx, dy, dw, None, None, *(d.to(m.dtype) for d, m in zip(dmaps, maps)))


@span("sampler.patch")
def patch_sample(fine_maps, cam, x, y, w, cam_k: int, lvl=None) -> torch.Tensor:
    """Fine-level sampling -> ``[bs, M0, C]`` float32. A CPU tensor takes
    :func:`patch_sample_plain`; anything else takes kernel K2
    (``kernels.patch_sample``) and, for its gradient, K2-bwd, or with
    ``lvl`` their level-k variants (``kernels.patch_sample_lk``,
    ``kernels.patch_sample_bwd_lk``); they raise off the card."""
    if x.device.type == "cpu":
        return patch_sample_plain(fine_maps, cam, x, y, w, cam_k, lvl)
    return _PatchSample.apply(cam, x, y, w, lvl, cam_k, *fine_maps)


def _keep_top_levels(w_fine: torch.Tensor, level_k: int, renorm: bool):
    """The level top-k of ``sampler_level_k`` (``hipad_tpu/ops/sampling.py:
    791-830``): for each compacted sample the ``level_k`` fine levels of
    largest group-weight mass, ties to the lower level as ``topk_by_argmax``
    breaks them. ``w_fine [bs, M, n_fine, G]`` (the inside mask and any
    camera renormalisation already in) -> (the kept levels' weights ``[bs,
    M, level_k, G]``, their indices ``[bs, M, level_k]`` int32). With
    ``renorm`` the kept weights of each sample are rescaled per group to the
    full fine mass (floor 1e-9; sums in fp32, the ratio in the weights'
    dtype, as the camera renormalisation)."""
    bs, M, n_fine, G = w_fine.shape
    # the mass in the weights' dtype, as the JAX package sums it
    mass = w_fine.float().sum(dim=-1).to(w_fine.dtype).float()
    lidx = ranking.topk(mass, level_k)[1]  # [bs, M, level_k]
    kept = torch.gather(w_fine, 2, lidx[..., None].expand(bs, M, level_k, G))
    if renorm:
        full = w_fine.float().sum(dim=2)
        ratio = full / torch.clamp(kept.float().sum(dim=2), min=1e-9)
        kept = kept * ratio.to(kept.dtype)[:, :, None]
    return kept, lidx.to(torch.int32)


def _coarse_inputs(points_2d: torch.Tensor, weights: torch.Tensor):
    """The camera-major inputs of :func:`interp_matmul_camsum` for every
    level: ``xf, yf [bs*cams, M0]`` normalised coordinates (fp32), ``insf
    [bs*cams, M0]`` the inside mask and ``wf [bs*cams, M0, L, G]`` the
    weights in fp32 times the mask."""
    bs, M0, num_cams, _ = points_2d.shape
    num_levels, groups = weights.shape[-2:]
    B = bs * num_cams
    xf = points_2d[..., 0].permute(0, 2, 1).reshape(B, M0).float()
    yf = points_2d[..., 1].permute(0, 2, 1).reshape(B, M0).float()
    insf = _inside(points_2d).permute(0, 2, 1).reshape(B, M0)
    wf = weights.permute(0, 2, 1, 3, 4).reshape(B, M0, num_levels, groups)
    return xf, yf, insf, wf.float() * insf[..., None, None]


@_autocast_off
def coarse_sample_plain(acc, coarse_maps: Sequence[torch.Tensor], points_2d: torch.Tensor,
                        weights: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Plain version of K1: ``acc`` (``[bs, M0, C]`` float32, or ``None`` for
    zero) plus :func:`interp_matmul_camsum` of each coarse level, added in
    the order given -> ``[bs, M0, C]`` float32.

    Args:
      coarse_maps: per-level ``[bs, cams, H, W, C]`` maps, ``coarse_maps[i]``
        at index ``levels[i]`` of the weights' level axis.
      points_2d: ``[bs, M0, cams, 2]`` normalised (x, y).
      weights: ``[bs, M0, cams, L, G]``.

    Each level samples at pixel coordinates ``x * W - 0.5``, ``y * H - 0.5``
    with the group weights ``weights[..., l, :]`` in fp32 times the inside
    mask (:func:`_inside`), on all cameras.
    """
    bs, M0, num_cams, _ = points_2d.shape
    B = bs * num_cams
    xf, yf, _, wf = _coarse_inputs(points_2d, weights)
    out = acc
    for lvl, feat in zip(levels, coarse_maps):
        h_l, w_l = feat.shape[2], feat.shape[3]
        term = interp_matmul_camsum(
            feat.reshape(B, h_l, w_l, feat.shape[-1]),
            (xf * w_l - 0.5).contiguous(), (yf * h_l - 0.5).contiguous(),
            wf[:, :, lvl].contiguous(), bs, num_cams)
        out = term if out is None else out + term
    return out


def coarse_sample_backward(gout: torch.Tensor, coarse_maps: Sequence[torch.Tensor],
                           points_2d: torch.Tensor, weights: torch.Tensor,
                           levels: Sequence[int], level_adjoint):
    """The adjoint of :func:`coarse_sample_plain` for the maps, the points and
    the weights (that of ``acc`` is ``gout`` itself).

    ``level_adjoint(fm, px, py, wg, gout, bs, cams) -> (d fm, d px, d py,
    d wg)`` is the adjoint of :func:`interp_matmul_camsum` on one level's
    camera-major inputs: K1-bwd (``kernels.interp_sample_camsum_bwd``) on the
    card; a test passes autograd of the plain version. The chain maps
    ``d px * W`` and ``d py * H`` back to the points and ``d wg * inside`` to
    the weights, zero on the levels not sampled -> (per-level d maps, d
    points in the points' dtype, d weights in the weights' dtype).
    """
    bs, M0, num_cams, _ = points_2d.shape
    num_levels, groups = weights.shape[-2:]
    B = bs * num_cams
    xf, yf, insf, wf = _coarse_inputs(points_2d, weights)
    gout = gout.float().contiguous()
    dxy = None
    dw = torch.zeros_like(wf)
    dmaps = []
    for lvl, feat in zip(levels, coarse_maps):
        h_l, w_l = feat.shape[2], feat.shape[3]
        dfm, dpx, dpy, dwg = level_adjoint(
            feat.reshape(B, h_l, w_l, feat.shape[-1]),
            (xf * w_l - 0.5).contiguous(), (yf * h_l - 0.5).contiguous(),
            wf[:, :, lvl].contiguous(), gout, bs, num_cams)
        dmaps.append(dfm.reshape(feat.shape))
        d = torch.stack([dpx * w_l, dpy * h_l], dim=-1)
        dxy = d if dxy is None else dxy + d
        dw[:, :, lvl] += dwg
    dpoints = dxy.reshape(bs, num_cams, M0, 2).permute(0, 2, 1, 3)
    dweights = (dw * insf[..., None, None]).reshape(bs, num_cams, M0, num_levels, groups)
    return (dmaps, dpoints.to(points_2d.dtype),
            dweights.permute(0, 2, 1, 3, 4).to(weights.dtype))


class _CoarseSample(torch.autograd.Function):
    """K1 forward (one launch); backward through K1-bwd, one call per coarse
    level, and the chain of :func:`coarse_sample_backward`. The maps ride
    last in ``*maps``."""

    @staticmethod
    def forward(ctx, acc, points_2d, weights, levels, *maps):
        ctx.save_for_backward(points_2d, weights, *maps)
        ctx.levels = levels
        return kernels.coarse_sample(acc, list(maps), points_2d, weights, levels)

    @staticmethod
    def backward(ctx, gout):
        points_2d, weights, *maps = ctx.saved_tensors
        dmaps, dpoints, dweights = coarse_sample_backward(
            gout, maps, points_2d, weights, ctx.levels, kernels.interp_sample_camsum_bwd)
        dacc = gout if ctx.needs_input_grad[0] else None
        return (dacc, dpoints, dweights, None, *dmaps)


@span("sampler.coarse")
def coarse_sample(acc, coarse_maps: Sequence[torch.Tensor], points_2d: torch.Tensor,
                  weights: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """``acc`` plus every coarse level's camera-summed sample ->
    ``[bs, M0, C]`` float32 (:func:`coarse_sample_plain` says what). A CPU
    tensor takes the plain version; anything else takes kernel K1
    (``kernels.coarse_sample``) and, for its gradient, K1-bwd; both raise
    off the card."""
    if points_2d.device.type == "cpu":
        return coarse_sample_plain(acc, coarse_maps, points_2d, weights, levels)
    return _CoarseSample.apply(acc, points_2d.float().contiguous(), weights.contiguous(),
                               tuple(levels), *coarse_maps)


def glue_on_card(*tensors: torch.Tensor) -> bool:
    """Whether the sampler's glue around K1 and K2 runs as its kernels
    (``kernels.cam_select``, ``kernels.point_sum``): tensors off the CPU,
    and autograd needing nothing of them. Otherwise (the CPU, the training
    step) the torch ops of :func:`select_cameras_plain` and
    :func:`point_sum_plain` run, and autograd goes through them."""
    return tensors[0].device.type != "cpu" and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def launch_plan(num_levels: int, matmul_levels: Sequence[int], level_k, grad: bool) -> dict:
    """The kernel launches of one :func:`deformable_aggregation_topk` call
    on the card, by kernel name (``kernels.KERNELS``), as
    :func:`_samples_flat` and :func:`deformable_aggregation_topk` make them:
    K1 once for every coarse level, K2 (its level-k variant under
    ``0 < level_k <`` the fine levels) once for every fine level; with
    ``grad`` (the training step), K1-bwd once a coarse level and K2-bwd (or
    its level-k variant) once, and no glue kernel; without, the camera
    selection once where there are fine levels and the point sum once
    (:func:`glue_on_card`)."""
    fine = [l for l in range(num_levels) if l not in matmul_levels]
    coarse = [l for l in matmul_levels if l < num_levels]
    lk = "_lk" if level_k is not None and 0 < level_k < len(fine) else ""
    plan = {"coarse_sample": int(bool(coarse)), f"patch_sample{lk}": int(bool(fine))}
    if grad:
        plan.update({"interp_sample_camsum_bwd": len(coarse),
                     f"patch_sample_bwd{lk}": int(bool(fine))})
    else:
        plan.update({"cam_select": int(bool(fine)), "point_sum": 1})
    return {k: n for k, n in plan.items() if n}


def select_cameras_plain(points_2d: torch.Tensor, weights: torch.Tensor, cam_k: int,
                         cam_renorm: bool, fine: Sequence[int]):
    """The camera selection in torch ops (plain version of
    ``kernels.cam_select``): each sample's ``cam_k`` cameras ranked by
    in-bounds-ness, ties to the lowest index as the JAX package's
    ``topk_by_argmax``, their points and their fine levels' weights times the
    inside mask; with ``cam_renorm`` and ``cam_k < cams`` the kept cameras'
    (level, group) weights rescaled to the full in-bounds mass (floor
    ``1e-9``; sums in fp32, the ratio in the weights' dtype).

    points_2d ``[bs, M0, cams, 2]``, weights ``[bs, M0, cams, L, G]``,
    ``fine`` indices of the weights' level axis -> (cam ``[bs, M]`` int32,
    x, y ``[bs, M]`` fp32, w_fine ``[bs, M, len(fine), G]`` fp32), ``M =
    M0*cam_k`` with the slot index fastest: what :func:`patch_sample`
    takes."""
    bs, M0, num_cams, _ = points_2d.shape
    num_levels, groups = weights.shape[-2:]
    inside = _inside(points_2d)  # [bs, M0, cams]
    # All keys distinct: in-bounds cameras first, lower index first.
    rank_key = inside.long() * num_cams - torch.arange(num_cams, device=inside.device)
    cam_idx = rank_key.topk(cam_k, dim=-1).indices  # [bs, M0, k]
    pts = torch.gather(points_2d, 2, cam_idx[..., None].expand(-1, -1, -1, 2))
    ins = torch.gather(inside, 2, cam_idx).to(weights.dtype)
    wts = torch.gather(weights, 2,
                       cam_idx[..., None, None].expand(-1, -1, -1, num_levels, groups))
    w = wts * ins[..., None, None]  # [bs, M0, k, L, G]
    if cam_renorm and cam_k < num_cams:
        # sums in fp32, the ratio in the weights' dtype: the same on both
        # devices (the card's autocast would return fp32 sums)
        full = (weights * inside[..., None, None].to(weights.dtype)).float().sum(dim=2)
        kept = w.float().sum(dim=2)
        w = w * (full / torch.clamp(kept, min=1e-9)).to(w.dtype)[:, :, None]
    M = M0 * cam_k
    return (cam_idx.reshape(bs, M).to(torch.int32),
            pts[..., 0].reshape(bs, M).float().contiguous(),
            pts[..., 1].reshape(bs, M).float().contiguous(),
            w.reshape(bs, M, num_levels, groups)[:, :, list(fine)].float().contiguous())


def point_sum_plain(flat: torch.Tensor, num_pts: int, dtype: torch.dtype) -> torch.Tensor:
    """Each anchor's points summed in torch ops (plain version of
    ``kernels.point_sum``): ``flat [bs, anchors*num_pts, C]`` fp32 rounded
    to ``dtype``, summed in fp32 over each anchor's consecutive points and
    rounded once -> ``[bs, anchors, C]`` of ``dtype``."""
    bs, M0, C = flat.shape
    return flat.to(dtype).reshape(bs, M0 // num_pts, num_pts, C).float().sum(dim=2).to(dtype)


def _samples_flat(feature_maps, points_2d, weights, cam_k, matmul_levels, cam_renorm,
                  level_k, level_renorm) -> torch.Tensor:
    """:func:`deformable_samples_topk_flat` before its output is rounded to
    the weights' dtype: ``[bs, M0, C]`` float32."""
    num_cams = points_2d.shape[2]
    num_levels = len(feature_maps)
    cam_k = min(cam_k, num_cams)
    out = None
    fine = [l for l in range(num_levels) if l not in matmul_levels]
    if fine:
        with span("sampler.select"):
            if glue_on_card(points_2d, weights):
                cam, x, y, w_fine = kernels.cam_select(
                    points_2d.float(), weights.contiguous(), cam_k, cam_renorm, fine)
            else:
                cam, x, y, w_fine = select_cameras_plain(points_2d, weights, cam_k,
                                                         cam_renorm, fine)
            lvl = None
            if level_k is not None and 0 < level_k < len(fine):
                w_fine, lvl = _keep_top_levels(w_fine.to(weights.dtype), level_k, level_renorm)
                w_fine = w_fine.float().contiguous()
        out = patch_sample([feature_maps[l] for l in fine], cam, x, y, w_fine, cam_k, lvl)

    coarse = [l for l in matmul_levels if l < num_levels]
    if coarse:
        out = coarse_sample(out, [feature_maps[l] for l in coarse], points_2d, weights, coarse)
    return out


def deformable_samples_topk_flat(
    feature_maps: Sequence[torch.Tensor],
    points_2d: torch.Tensor,  # [bs, M0, cams, 2]
    weights: torch.Tensor,  # [bs, M0, cams, L, G]
    cam_k: int = 3,
    matmul_levels: Sequence[int] = (2, 3),
    cam_renorm: bool = False,
    level_k=None,
    level_renorm: bool = True,
) -> torch.Tensor:
    """Camera-compacted hybrid sampler on flat samples -> ``[bs, M0, C]``.

    Each sample keeps the ``cam_k`` cameras ranked by in-bounds-ness, with
    ``cam_renorm`` renormalised (:func:`select_cameras_plain`; on a card,
    with no gradient wanted, ``kernels.cam_select``: :func:`glue_on_card`).
    The levels not in ``matmul_levels`` are sampled by :func:`patch_sample`
    on the compacted samples (one launch of K2 on the card), then the levels
    in it by :func:`coarse_sample` on all cameras, added to K2's sum (one
    launch of K1 for all of them). With ``0 < level_k <`` the number of fine
    levels, each compacted sample reads only its ``level_k`` fine levels of
    largest mass (:func:`_keep_top_levels`, renormalised with
    ``level_renorm``), each from that level's own map (K2's level-k variant
    on the card).
    """
    return _samples_flat(feature_maps, points_2d, weights, cam_k, matmul_levels, cam_renorm,
                         level_k, level_renorm).to(weights.dtype)


@span("sampler")
def deformable_aggregation_topk(
    feature_maps: Sequence[torch.Tensor],
    points_2d: torch.Tensor,
    weights: torch.Tensor,
    cam_k: int = 3,
    matmul_levels: Sequence[int] = (2, 3),
    cam_renorm: bool = False,
    level_k=None,
    level_renorm: bool = True,
) -> torch.Tensor:
    """The sampler: :func:`deformable_samples_topk_flat` on the flattened
    (anchor, point) samples, summed over each anchor's points ->
    ``[bs, anchors, C]`` in the weights' dtype (:func:`point_sum_plain`; on
    a card, with no gradient wanted, ``kernels.point_sum``)."""
    bs, num_anchor, num_pts, num_cams, _ = points_2d.shape
    flat = _samples_flat(
        feature_maps,
        points_2d.reshape(bs, num_anchor * num_pts, num_cams, 2),
        weights.reshape(bs, num_anchor * num_pts, num_cams,
                        weights.shape[-2], weights.shape[-1]),
        cam_k, matmul_levels, cam_renorm, level_k, level_renorm,
    )
    with span("sampler.sum"):
        if glue_on_card(flat):
            return kernels.point_sum(flat, num_pts, weights.dtype)
        return point_sum_plain(flat, num_pts, weights.dtype)


def front_view_feature(feature_maps: List[torch.Tensor], level: int = -1,
                       cam: int = 0) -> torch.Tensor:
    """One camera's map at one pyramid level: ``[bs, H, W, C]``."""
    return feature_maps[level][:, cam]
