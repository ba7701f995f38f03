"""Weights across the two packages, and a seeded random initialisation.

The port names every submodule after its flax tree path, so the mapping
needs no name table, only three layout rules (and their inverses):

  * Dense ``kernel [I, O]``         <-> Linear ``weight [O, I]``;
  * Conv ``kernel [kh, kw, I, O]``  <-> Conv2d ``weight [O, I, kh, kw]``;
  * LayerNorm / BatchNorm / Scale ``scale`` <-> ``weight``, and BatchNorm
    ``batch_stats`` ``mean`` / ``var`` <-> ``running_mean`` / ``running_var``.

Every other leaf (``bias``, the decoder's ``det_anchor``, ``det_feature``
...) keeps its name and layout. A released reference checkpoint reaches the
port through the JAX package's converter: ``tools/convert_weights.py``'s
``convert``, then :func:`from_jax`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{"params": ..., "batch_stats": ...}`` (numpy leaves) -> state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for coll, tree in variables.items():
        if coll not in ("params", "batch_stats"):
            raise ValueError(f"unknown variable collection {coll!r}")
        for path, leaf in _flatten(tree):
            *mods, name = path
            arr = np.asarray(leaf)
            if coll == "batch_stats":
                name = {"mean": "running_mean", "var": "running_var"}[name]
            elif name == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                else:
                    raise ValueError(f"kernel {'/'.join(path)} has shape {arr.shape}")
                name = "weight"
            elif name == "scale":
                name = "weight"
            sd[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Inverse of :func:`from_jax`: state_dict -> nested numpy variables."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        arr = t.detach().cpu().numpy()
        coll = "params"
        if name in ("running_mean", "running_var"):
            coll, name = "batch_stats", name[len("running_"):]
        elif name == "weight":
            if arr.ndim == 2:
                arr, name = arr.T, "kernel"
            elif arr.ndim == 4:
                arr, name = arr.transpose(2, 3, 1, 0), "kernel"
            elif arr.ndim == 1:
                name = "scale"
            else:
                raise ValueError(f"weight {key} has shape {arr.shape}")
        node = out[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


@torch.no_grad()
def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, drawn on each parameter's own device from a
    ``torch.Generator`` (the global RNG is not touched).

    Linear weights ~ N(0, 1/fan_in), conv weights ~ N(0, 2/fan_in), biases
    zero except the classification heads' focal-style bias; norms start at
    identity. The anchor-regression outputs (det/map ``reg_out``, plan
    ``reg_*_out``) are drawn 100x smaller, the usual detection-head
    convention: at full scale, random regression heads move every det anchor
    by metres per layer, and the loop anchor -> keypoints -> sampled feature
    -> anchor then amplifies any rounding difference about tenfold per
    layer. The decoder's anchors come from the config and its
    ``map_feature`` is Xavier-uniform, as in the JAX package. Unlike the JAX
    package, which zero-initialises ``weights_fc``, it is drawn like every
    other Linear, so that the sampler's softmax weights are not uniform.
    """
    from .models.common import BatchNorm, Scale, cls_bias_init
    from .models.decoder import SparseOneDecoder
    from .models.refine import (ClsHead, SparseBox3DRefinement, SparsePlanAlignRefinement,
                                SparsePoint3DRefinement)

    gens: Dict[torch.device, torch.Generator] = {}

    def gen(t: torch.Tensor) -> torch.Generator:
        if t.device not in gens:
            gens[t.device] = torch.Generator(device=t.device).manual_seed(seed)
        return gens[t.device]

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt((2.0 if isinstance(mod, nn.Conv2d) else 1.0) / fan_in)
            mod.weight.normal_(0.0, std, generator=gen(mod.weight))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, Scale):
            mod.weight.fill_(1.0)
    for mod in model.modules():  # after the generic pass, which zeroes biases
        if isinstance(mod, ClsHead):
            mod.out.bias.fill_(cls_bias_init())
        if isinstance(mod, (SparseBox3DRefinement, SparsePoint3DRefinement,
                            SparsePlanAlignRefinement)):
            for name, sub in mod.named_children():
                if name.startswith("reg_") and name.endswith("out"):
                    sub.weight.mul_(0.01)
        if isinstance(mod, SparseOneDecoder):
            cfg = mod.cfg
            for name in ("det_anchor", "map_anchor", "plan_anchor"):
                getattr(mod, name).copy_(torch.as_tensor(np.asarray(getattr(cfg, name),
                                                                    np.float32)))
            mod.det_feature.zero_()
            a = math.sqrt(6.0 / sum(mod.map_feature.shape))
            mod.map_feature.uniform_(-a, a, generator=gen(mod.map_feature))
    return model
