"""Shared building blocks: MLP stacks, attention, FFN, eval-mode BatchNorm.

Counterparts of ``hipad_tpu/models/common.py``. Submodules carry the flax
module names (``fc_{o}_{i}``, ``ln_{o}``, ``q_proj`` ...) so that
``hipad_torch.weights`` maps parameters by path alone. LayerNorm and
BatchNorm use epsilon 1e-5, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


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
            self.add_module(f"ln_{o}", nn.LayerNorm(embed_dims, eps=1e-5))

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


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 in eval mode (running statistics), epsilon 1e-5.
    The forward is inference only, so no batch counter is kept."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, momentum=0.0, eps=self.eps)


class MultiheadAttention(nn.Module):
    """Multi-head attention with additive positional embeddings and a
    residual: key defaults to query, value to key; positions are added
    before the projections; output = query (before the position add) +
    out_proj(attention). ``attn_bias`` is added to the logits."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
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
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out = out.transpose(1, 2).reshape(bs, nq, d)
        return identity + self.out_proj(out)


class AsymmetricFFN(nn.Module):
    """pre-LN(in_channels) -> Linear(ffn) -> ReLU -> Linear(embed_dims), plus
    the identity projected by ``identity_fc`` when the widths differ."""

    def __init__(self, in_channels: int, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.pre_norm = nn.LayerNorm(in_channels, eps=1e-5)
        self.fc1 = nn.Linear(in_channels, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)
        self.identity_fc = (nn.Linear(in_channels, embed_dims)
                            if in_channels != embed_dims else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_norm(x)
        out = self.fc2(F.relu(self.fc1(x)))
        identity = x if self.identity_fc is None else self.identity_fc(x)
        return identity + out
