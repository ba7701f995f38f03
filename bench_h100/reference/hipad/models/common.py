# Frozen copy of hipad_torch/models/common.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Shared building blocks: MLP stacks, attention, FFN, BatchNorm, dropout.

Counterparts of ``hipad_tpu/models/common.py``. Submodules carry the flax
module names (``fc_{o}_{i}``, ``ln_{o}``, ``q_proj`` ...) so that
``hipad_torch.weights`` maps parameters by path alone. LayerNorm and
BatchNorm use epsilon 1e-5, as the JAX package does.

Train mode (``module.train()``) turns on BatchNorm's batch statistics and
dropout. Dropout draws its mask from the ``torch.Generator`` the caller
passes down the forward (``generator=``), never from the global RNG.

Reduced precision: under bf16 autocast, :func:`compute_dtype` is flax's
module ``dtype``. Where autocast's op lists differ between the CPU and the
card for an op on the path (softmax, layer_norm, sum, nearest upsampling
run in fp32 on the card and in their input's dtype on the CPU), the port
takes the op in fp32 explicitly and casts its output to ``compute_dtype``,
as flax does, so both devices run the same arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def to_float32(tree):
    """The floating tensors of a nested dict / list / tuple as fp32, the
    rest as they are: losses and post-processing run in fp32 whatever the
    forward's autocast produced."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_float32(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype activations take here: autocast's for ``x``'s device when
    it is on (flax's module ``dtype``), else ``x``'s own."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's precision: statistics and normalisation
    in fp32, the output in :func:`compute_dtype` (the card's autocast would
    return fp32, the CPU's the input's dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(compute_dtype(x))


class MLPLN(nn.Module):
    """[Linear, ReLU] * in_loops followed by LayerNorm, repeated out_loops."""

    def __init__(self, in_dims: int, embed_dims: int, in_loops: int = 1, out_loops: int = 2):
        super().__init__()
        self.in_loops, self.out_loops = in_loops, out_loops
        d = in_dims
        for o in range(out_loops):
            for i in range(in_loops):
                self.add_module(f"fc_{o}_{i}", nn.Linear(d, embed_dims))
                d = embed_dims
            self.add_module(f"ln_{o}", LayerNorm(embed_dims, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for o in range(self.out_loops):
            for i in range(self.in_loops):
                x = F.relu(getattr(self, f"fc_{o}_{i}")(x))
            x = getattr(self, f"ln_{o}")(x)
        return x


class MLP(nn.Module):
    """Linear(+ReLU) per hidden width, final Linear without activation."""

    def __init__(self, in_dims: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        d = in_dims
        for i, f in enumerate(features):
            self.add_module(f"fc_{i}", nn.Linear(d, f))
            d = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        return getattr(self, f"fc_{self.n - 1}")(x)


class Scale(nn.Module):
    """Per-channel learnable scale. Its parameter is named ``weight`` (flax
    ``scale``), like every other 1-D scale in the port."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight


def cls_bias_init(prior_prob: float = 0.01) -> float:
    """Focal-loss style classification bias (mmcv ``bias_init_with_prob``)."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator], mask_shape=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - p`` and
    scale the kept ones by ``1 / (1 - p)``; the identity unless ``training``
    and ``p > 0``. The mask, of ``x``'s shape or of ``mask_shape``
    broadcast against it, is drawn from ``generator``, which must be given
    then."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode draws from an explicit torch.Generator: "
                         "pass generator=")
    keep = torch.rand(mask_shape or x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _global_var_mean(x: torch.Tensor, dims, group):
    """The biased variance and the mean over ``dims`` of ``x`` on every
    process of ``group`` (equal local shapes), differentiable."""
    from torch.distributed.nn.functional import all_reduce

    n = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
    mean = all_reduce(x.sum(dim=dims), group=group) / n
    shape = [1, -1] + [1] * (x.dim() - 2)
    dev = x - mean.view(shape)
    var = all_reduce((dev * dev).sum(dim=dims), group=group) / n
    return var, mean


class BatchNorm(nn.Module):
    """BatchNorm over dim 1, epsilon 1e-5, as flax ``nn.BatchNorm`` with
    momentum 0.9. Eval mode normalises with the running statistics. Train
    mode normalises with the batch mean and the BIASED batch variance, all in
    fp32 and rounded once to the input's dtype, and updates ``running = 0.9 *
    running + 0.1 * batch`` with that biased variance
    (``F.batch_norm(training=True)`` would store the unbiased one).

    With ``group`` set (by ``HiPAD(cfg, group=...)``) the train-mode
    statistics are those of the batches of all the group's processes, as
    flax takes them over a sharded global batch: the sum, then the sum of
    squared deviations from the global mean, each all-reduced with autograd
    (``torch.nn.SyncBatchNorm`` takes no CPU tensors)."""

    momentum = 0.9
    group = None  # a torch.distributed process group, or None

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, momentum=0.0, eps=self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.group is None:
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
        else:
            var, mean = _global_var_mean(x.float(), dims, self.group)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        # in fp32, rounded once to the input's dtype, as flax normalises
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention with additive positional embeddings and a
    residual: key defaults to query, value to key; positions are added
    before the projections; output = query (before the position add) +
    out_proj(attention). ``attn_bias`` is added to the logits. In train mode
    a dropout of rate ``drop`` acts on the attention probabilities and on the
    projected output (the JAX package's ``attn_drop`` and ``proj_drop``, both
    ``cfg.drop_out``)."""

    def __init__(self, embed_dims: int, num_heads: int, drop: float = 0.0):
        super().__init__()
        self.embed_dims, self.num_heads, self.drop = embed_dims, num_heads, drop
        self.q_proj = nn.Linear(embed_dims, embed_dims)
        self.k_proj = nn.Linear(embed_dims, embed_dims)
        self.v_proj = nn.Linear(embed_dims, embed_dims)
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def forward(
        self,
        query: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_pos: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        identity = query
        if key is None:
            key = query
            if key_pos is None and query_pos is not None and query_pos.shape == key.shape:
                key_pos = query_pos
        if value is None:
            value = key
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None:
            key = key + key_pos
        h = self.num_heads
        bs, nq, d = query.shape
        nk = key.shape[1]
        q = self.q_proj(query).reshape(bs, nq, h, d // h).transpose(1, 2)
        k = self.k_proj(key).reshape(bs, nk, h, d // h).transpose(1, 2)
        v = self.v_proj(value).reshape(bs, nk, h, d // h).transpose(1, 2)
        mask = None if attn_bias is None else attn_bias.to(q.dtype)
        if self.training and self.drop > 0.0:
            # dropout on the probabilities, as the JAX package draws it
            logits = q @ k.transpose(-1, -2) / math.sqrt(d // h)
            if mask is not None:
                logits = logits + mask
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            out = dropout(probs, self.drop, True, generator) @ v
        else:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out = out.transpose(1, 2).reshape(bs, nq, d)
        out = dropout(self.out_proj(out), self.drop, self.training, generator)
        return identity + out


class AsymmetricFFN(nn.Module):
    """pre-LN(in_channels) -> Linear(ffn) -> ReLU -> Linear(embed_dims), plus
    the identity projected by ``identity_fc`` when the widths differ."""

    def __init__(self, in_channels: int, embed_dims: int, feedforward_channels: int,
                 ffn_drop: float = 0.0):
        super().__init__()
        self.ffn_drop = ffn_drop
        self.pre_norm = LayerNorm(in_channels, eps=1e-5)
        self.fc1 = nn.Linear(in_channels, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)
        self.identity_fc = (nn.Linear(in_channels, embed_dims)
                            if in_channels != embed_dims else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.pre_norm(x)
        out = dropout(F.relu(self.fc1(x)), self.ffn_drop, self.training, generator)
        out = dropout(self.fc2(out), self.ffn_drop, self.training, generator)
        identity = x if self.identity_fc is None else self.identity_fc(x)
        return identity + out
