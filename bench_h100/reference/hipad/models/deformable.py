# Frozen copy of hipad_torch/models/deformable.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Deformable feature aggregation (counterpart of
``hipad_tpu/models/deformable.py``).

With ``sampler_point_frac < 1`` (the serving knob of
``stage2_serving``) :meth:`prepare` keeps only ``ceil(frac * P)`` keypoints
of each anchor, ranked by their in-bounds weight mass, and rescales the
kept weights to the full mass, so the sampler's kernels see fewer samples.
``sampler_level_k`` keeps each compacted sample's ``level_k`` fine levels of
largest mass (``ops/sampling.py``). With ``use_points_embed = S > 0`` (the
point-expanded map and plan queries of ``with_deform_*_points``) the
anchor embed is per sample point, ``[bs, n * S, C]``, and the weights head
reads each anchor's S points' features side by side (``S * C`` wide), its
feature tiled over its own points.

The samplers: ``"topk"`` (the default), ``"zero"`` (an ablation that samples
nothing) and ``"reference"``, the exact oracle. On the CPU ``"reference"``
runs the plain oracle (``ops/sampling.py:deformable_aggregation``). On the
card it runs the topk sampler with every camera kept and no
renormalisation, the same function: both drop a sample outside the open
unit square, with ``cam_k = cams`` every camera it lies in is kept, K2's
hat weights against the clamped patch origin give a corner off the map
weight zero as the oracle's per-corner validity does, and K1's dense
interpolation has no cell off the map.

In train mode a dropout of rate ``attn_drop`` drops whole (anchor, camera,
point) columns of the sampling weights. It is 0.15, the JAX package's
default, which its decoder never overrides: ``cfg.drop_out`` does not
reach it.

keypoints -> camera projection -> camera-conditioned softmax weights ->
multi-view multi-scale bilinear sampling -> output projection with the
"cat" residual (width doubles; the AsymmetricFFN squeezes it back).

The keypoint generator lives at decoder level (flax path
``decoder/{task}_kps_{i}``), so it is passed to :meth:`prepare` and
:meth:`forward` rather than owned here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.geometry import project_points
from ..ops import ranking
from ..ops.sampling import deformable_aggregation, deformable_aggregation_topk
from .common import MLPLN, compute_dtype, dropout
from .keypoints import BoxKeypoints

SAMPLERS = ("topk", "zero", "reference")


class DeformableAggregation(nn.Module):
    attn_drop = 0.15

    def __init__(self, embed_dims: int, num_groups: int, num_levels: int,
                 num_cams: int, num_pts: int, sampler: str = "topk",
                 sampler_cam_k: int = 3, sampler_cam_renorm: bool = False,
                 sampler_matmul_levels: Tuple[int, ...] = (2, 3),
                 sampler_point_frac: float = 1.0, sampler_level_k: Optional[int] = None,
                 sampler_level_renorm: bool = True, use_points_embed: int = 0):
        super().__init__()
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
        self.embed_dims, self.num_groups = embed_dims, num_groups
        self.num_levels, self.num_cams, self.num_pts = num_levels, num_cams, num_pts
        self.sampler = sampler
        self.cam_k, self.cam_renorm = sampler_cam_k, sampler_cam_renorm
        self.matmul_levels = tuple(sampler_matmul_levels)
        self.point_frac = sampler_point_frac
        self.level_k, self.level_renorm = sampler_level_k, sampler_level_renorm
        self.points_embed = use_points_embed
        self.camera_encoder = MLPLN(12, embed_dims, 1, 2)
        self.weights_fc = nn.Linear(embed_dims * max(1, use_points_embed),
                                    num_groups * num_levels * num_pts)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def prepare(self, kps: nn.Module, instance_feature: torch.Tensor,
                anchor: torch.Tensor, anchor_embed: torch.Tensor,
                projection_mat: torch.Tensor, image_wh: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """-> (points_2d [bs, n, P, cams, 2], weights [bs, n, P, cams, L, G])."""
        bs, n = instance_feature.shape[:2]
        # The box generator's offsets read the anchor embed, the polyline
        # generator's the instance feature (the reference's positional call
        # ``kps_generator(anchor, anchor_embed, instance_feature)``).
        kps_in = anchor_embed if isinstance(kps, BoxKeypoints) else instance_feature
        key_points = kps(anchor, kps_in)  # [bs, n, P, 3]
        num_pts = key_points.shape[2]

        cam_embed = self.camera_encoder(
            projection_mat[:, :, :3, :].reshape(bs, self.num_cams, 12))
        if self.points_embed:
            # [bs, n*S, C] per-point embeds; each feature tiled over its own
            # anchor's points, the S points' features side by side per camera
            S = self.points_embed
            pf = ((instance_feature.repeat_interleave(S, dim=1) + anchor_embed)[:, :, None]
                  + cam_embed[:, None])
            feat = pf.reshape(bs, n, S, self.num_cams, -1).transpose(2, 3).reshape(
                bs, n, self.num_cams, -1)
        else:
            feat = (instance_feature + anchor_embed)[:, :, None] + cam_embed[:, None]
        w = self.weights_fc(feat)  # [bs, n, cams, G*L*P]
        # softmax over (cams, levels, points) per group, in this exact order
        w = w.reshape(bs, n, self.num_cams * self.num_levels * num_pts, self.num_groups)
        # in fp32, rounded to the compute dtype as flax's softmax of its
        # bf16 logits (the card's autocast would keep fp32, the CPU's bf16)
        w = torch.softmax(w.float(), dim=-2).to(compute_dtype(w))
        w = w.reshape(bs, n, self.num_cams, self.num_levels, num_pts, self.num_groups)
        w = dropout(w, self.attn_drop, self.training, generator,
                    mask_shape=(bs, n, self.num_cams, 1, num_pts, 1))

        pts_cam = project_points(key_points, projection_mat, image_wh)  # [bs, cams, n, P, 2]
        if self.point_frac < 1.0:
            return self._keep_top_points(pts_cam, w)
        w = w.permute(0, 1, 4, 2, 3, 5)  # [bs, n, P, cams, L, G]
        pts2d = pts_cam.permute(0, 2, 3, 1, 4)  # [bs, n, P, cams, 2]
        return pts2d, w

    def _keep_top_points(self, pts_cam: torch.Tensor, w: torch.Tensor):
        """Early keypoint top-k: keep the ``ceil(frac * P)`` points of each
        anchor with the most in-bounds weight mass (ties to the lower point,
        as the JAX package's ``topk_by_argmax``),
        their weights scaled per (camera, level, group) so that the kept mass
        equals the full in-bounds mass (floor 1e-9). ``pts_cam [bs, cams, n,
        P, 2]``, ``w [bs, n, cams, L, P, G]`` -> (points ``[bs, n, kp, cams,
        2]``, weights ``[bs, n, kp, cams, L, G]``)."""
        bs, n, cams, L, P, G = w.shape
        kp = max(1, int(-(-P * self.point_frac // 1)))
        inside = ((pts_cam > 0.0) & (pts_cam < 1.0)).all(dim=-1).permute(0, 2, 1, 3)
        wm = w * inside[:, :, :, None, :, None].to(w.dtype)  # [bs, n, cams, L, P, G]
        imp = wm.float().sum(dim=(2, 3, 5))  # [bs, n, P]
        pidx = ranking.topk(imp, kp)[1]
        at = pidx[:, :, None, None, :, None].expand(bs, n, cams, L, kp, G)
        ratio = (wm.float().sum(dim=4) / torch.clamp(torch.gather(wm, 4, at).float().sum(dim=4),
                                                     min=1e-9)).to(w.dtype)
        w = torch.gather(w, 4, at) * ratio[:, :, :, :, None]
        pts = torch.gather(pts_cam, 3, pidx[:, None, :, :, None].expand(bs, cams, n, kp, 2))
        return pts.permute(0, 2, 3, 1, 4), w.permute(0, 1, 4, 2, 3, 5)

    def finish(self, features: torch.Tensor, instance_feature: torch.Tensor):
        return torch.cat([self.output_proj(features), instance_feature], dim=-1)

    def forward(self, kps: nn.Module, instance_feature: torch.Tensor,
                anchor: torch.Tensor, anchor_embed: torch.Tensor,
                feature_maps: Sequence[torch.Tensor], projection_mat: torch.Tensor,
                image_wh: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pts2d, w = self.prepare(kps, instance_feature, anchor, anchor_embed,
                                projection_mat, image_wh, generator)
        if self.sampler == "zero":
            # ablation: full prepare cost, no sampling
            features = (torch.zeros(instance_feature.shape[:2] + (self.embed_dims,),
                                    dtype=w.dtype, device=w.device)
                        + 0.0 * (w.sum() + pts2d.sum().to(w.dtype)))
        elif self.sampler == "topk":
            features = deformable_aggregation_topk(
                feature_maps, pts2d, w, cam_k=self.cam_k,
                matmul_levels=self.matmul_levels, cam_renorm=self.cam_renorm,
                level_k=self.level_k, level_renorm=self.level_renorm)
        elif pts2d.device.type == "cpu":
            features = deformable_aggregation(feature_maps, pts2d, w)
        else:  # the oracle's function through K1 and K2 (module docstring)
            features = deformable_aggregation_topk(
                feature_maps, pts2d, w, cam_k=self.num_cams,
                matmul_levels=self.matmul_levels, cam_renorm=False)
        return self.finish(features, instance_feature)
