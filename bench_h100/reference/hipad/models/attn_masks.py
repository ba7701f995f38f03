# Frozen copy of hipad_torch/models/attn_masks.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""The distance and velocity attention biases of the interactive attention
(counterpart of ``hipad_tpu/models/attn_masks.py``; off in every shipped
config, on with ``with_distance_attn_mask`` / ``with_velocity_attn_mask``).

  * distance: per (query, key) the least distance between the two
    instances' anchor points, scaled by a per-head tau predicted from the
    query features: ``bias = -dist * tau``;
  * velocity: query speed minus key speed, shifted to <= 0 by its largest
    value over the whole batch, scaled by a learned tau: ``bias = dv * tau``.

det and ego anchors contribute their centre (point level), map and plan
their polyline vertices (instance level, the least distance over vertices).
The decoder adds the biases into the logits of the inter_gnn op's one group.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.box3d import VX

POINT_LEVEL = {"ego": "point", "det": "point", "map": "instance", "plan": "instance"}


def _geometry(name: str, anchors: Dict[str, torch.Tensor], bs: int) -> torch.Tensor:
    a = anchors[name]
    if name in ("det", "ego"):
        return a[..., :2]  # [bs, n, 2]
    return a.reshape(bs, a.shape[1], -1, 2)  # [bs, n, P, 2]


def min_distance_matrix(q_names: Sequence[str], k_names: Sequence[str],
                        anchors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> ``[bs, Nq, Nk]`` least point distance, queries and keys in the
    order of their names."""
    bs = next(iter(anchors.values())).shape[0]
    rows = []
    for qn in q_names:
        qp = _geometry(qn, anchors, bs)
        cols = []
        for kn in k_names:
            kp = _geometry(kn, anchors, bs)
            ql, kl = POINT_LEVEL[qn], POINT_LEVEL[kn]
            if ql == "point" and kl == "point":
                d = torch.linalg.vector_norm(qp[:, :, None] - kp[:, None], dim=-1)
            elif ql == "point":
                d = torch.linalg.vector_norm(qp[:, :, None, None] - kp[:, None], dim=-1)
                d = d.min(dim=-1).values
            elif kl == "point":
                d = torch.linalg.vector_norm(qp[:, :, None] - kp[:, None, :, None], dim=-1)
                d = d.min(dim=-1).values
            else:
                d = torch.linalg.vector_norm(qp[:, :, None, :, None] - kp[:, None, :, None],
                                             dim=-1)
                d = d.reshape(bs, qp.shape[1], kp.shape[1], -1).min(dim=-1).values
            cols.append(d)
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=-2)


def speed_diff_matrix(q_names: Sequence[str], k_names: Sequence[str],
                      anchors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-> ``[bs, Nq, Nk]`` query speed minus key speed, less its largest
    value (over the whole batch, as the JAX package takes it); only det
    anchors carry a velocity."""
    bs = next(iter(anchors.values())).shape[0]

    def speed(name):
        a = anchors[name]
        if name == "det":
            return torch.linalg.vector_norm(a[..., VX:VX + 2], dim=-1)
        return torch.zeros((bs, a.shape[1]), dtype=a.dtype, device=a.device)

    rows = []
    for qn in q_names:
        sq = speed(qn)
        rows.append(torch.cat([sq[:, :, None] - speed(kn)[:, None] for kn in k_names], dim=-1))
    v = torch.cat(rows, dim=-2)
    return v - v.max()


class TauHead(nn.Module):
    """Per-head positive scale from the query features: a Linear to
    ``num_heads`` and a softplus -> ``[bs, Nq, heads]``. The softplus runs
    in fp32 and is rounded to the Linear's output dtype, as flax computes
    it in the module dtype (the card's autocast would keep fp32)."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.tau = nn.Linear(embed_dims, num_heads)

    def forward(self, q_feat: torch.Tensor) -> torch.Tensor:
        t = self.tau(q_feat)
        return F.softplus(t.float()).to(t.dtype)


def distance_bias(dist: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """-> ``[bs, heads, Nq, Nk]`` additive logit bias."""
    return -dist[:, None] * tau.transpose(1, 2)[..., None]


def velocity_bias(dv: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """-> ``[bs, heads, Nq, Nk]`` additive logit bias."""
    return dv[:, None] * tau.transpose(1, 2)[..., None]


def pair_ban_bias(q_names: Sequence[str], k_names: Sequence[str],
                  sections_q: Dict[str, Tuple[int, int]],
                  sections_k: Dict[str, Tuple[int, int]],
                  banned: Sequence[Tuple[str, str]], device=None) -> torch.Tensor:
    """Static modality-pair ban: ``-1e9`` on the banned (query, key)
    modality pairs -> ``[Nq, Nk]`` (broadcasts over batch and heads)."""
    nq = sum(sections_q[m][1] - sections_q[m][0] for m in q_names)
    nk = sum(sections_k[m][1] - sections_k[m][0] for m in k_names)
    bias = torch.zeros(nq, nk, device=device)
    q_ofs = 0
    for qn in q_names:
        qs = sections_q[qn][1] - sections_q[qn][0]
        k_ofs = 0
        for kn in k_names:
            ks = sections_k[kn][1] - sections_k[kn][0]
            if (qn, kn) in banned:
                bias[q_ofs:q_ofs + qs, k_ofs:k_ofs + ks] = -1e9
            k_ofs += ks
        q_ofs += qs
    return bias
