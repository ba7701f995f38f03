"""Seeded random weights, made by the benchmark and handed to both sides.

The rules are those of a detection model's usual initialisation: Linear
weights ~ N(0, 1/fan_in), convolutions ~ N(0, 2/fan_in), biases zero but the
classification heads' focal bias, norms at identity, the anchor-regression
outputs 100x smaller (a random head at full scale moves every anchor by
metres a layer, and the loop anchor -> keypoints -> sample -> anchor then
amplifies rounding tenfold a layer), the decoder's anchors from the
configuration, ``det_feature`` zero and ``map_feature`` Xavier-uniform.

The values are drawn on the device in two calls (one normal, one uniform
buffer) from a ``torch.Generator`` seeded by the run's seed, and scaled
tensor by tensor. The layout is read from the reference's module tree, whose
names are the program's: the program loads the result with
``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..reference.hipad.models.common import BatchNorm, Scale, cls_bias_init
from ..reference.hipad.models.decoder import SparseOneDecoder
from ..reference.hipad.models.refine import (ClsHead, SparseBox3DRefinement,
                                              SparsePlanAlignRefinement,
                                              SparsePoint3DRefinement)

WEIGHT_STREAM = 0x5EED  # keeps the weights' draws apart from the traffic's


def make_weights(ref_model: nn.Module, cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """-> a state dict for ``ref_model``'s layout, every entry on ``device``."""
    device = torch.device(device)
    sd = ref_model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    normal: Dict[str, float] = {}
    small = set()
    for name, mod in ref_model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal[pre + "weight"] = math.sqrt((2.0 if isinstance(mod, nn.Conv2d) else 1.0) / fan_in)
            if mod.bias is not None:
                out[pre + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            out[pre + "weight"] = torch.ones(mod.weight.shape, device=device)
            out[pre + "bias"] = torch.zeros(mod.bias.shape, device=device)
            if isinstance(mod, BatchNorm):
                out[pre + "running_mean"] = torch.zeros(mod.running_mean.shape, device=device)
                out[pre + "running_var"] = torch.ones(mod.running_var.shape, device=device)
        elif isinstance(mod, Scale):
            out[pre + "weight"] = torch.ones(mod.weight.shape, device=device)
    for name, mod in ref_model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, ClsHead):
            out[pre + "out.bias"] = torch.full(mod.out.bias.shape, cls_bias_init(), device=device)
        if isinstance(mod, (SparseBox3DRefinement, SparsePoint3DRefinement,
                            SparsePlanAlignRefinement)):
            for child, _ in mod.named_children():
                if child.startswith("reg_") and child.endswith("out"):
                    small.add(f"{pre}{child}.weight")
        if isinstance(mod, SparseOneDecoder):
            for key in ("det_anchor", "map_anchor", "plan_anchor"):
                out[pre + key] = torch.as_tensor(np.asarray(getattr(cfg, key), np.float32),
                                                 device=device)
            out[pre + "det_feature"] = torch.zeros(mod.det_feature.shape, device=device)
            uni_name, uni_shape = pre + "map_feature", mod.map_feature.shape

    gen = torch.Generator(device=device).manual_seed(seed * 2 + WEIGHT_STREAM)
    names = sorted(normal)
    sizes = [sd[n].numel() for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = [p.view(sd[n].shape) for p, n in zip(torch.split(flat, sizes), names)]
    torch._foreach_mul_(parts, [normal[n] * (0.01 if n in small else 1.0) for n in names])
    out.update(zip(names, parts))
    a = math.sqrt(6.0 / sum(uni_shape))
    out[uni_name] = torch.rand(uni_shape, generator=gen, device=device) * (2 * a) - a

    missing = set(sd) - set(out)
    if missing:
        raise ValueError(f"the weight rules leave {sorted(missing)[:5]} unset")
    return {k: out[k] for k in sd}
