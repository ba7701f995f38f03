# Frozen copy of hipad_torch/models/attention_blocks.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""Group-separated attention over the concatenated multi-task query set
(counterpart of ``hipad_tpu/models/attention_blocks.py``).

For decoupled groups the query and key are feature||pos-embed concatenations
at twice the width; values are lifted by the shared ``fc_before`` (C -> 2C)
and outputs squeezed by the shared ``fc_after`` (2C -> C). Both belong to
the decoder and are passed in.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .common import MultiheadAttention

Sections = Dict[str, Tuple[int, int]]


def section_gather(x: torch.Tensor, names: Sequence[str], sections: Sections) -> torch.Tensor:
    parts = [x[:, sections[m][0]:sections[m][1]] for m in names]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def section_scatter(out: torch.Tensor, update: torch.Tensor, names: Sequence[str],
                    sections: Sections) -> torch.Tensor:
    """Copy of ``out`` with each named section replaced by its slice of
    ``update`` (in order)."""
    out = out.clone()
    ofs = 0
    for m in names:
        s, e = sections[m]
        out[:, s:e] = update[:, ofs:ofs + (e - s)]
        ofs += e - s
    return out


def self_attention_groups(separate_list, decouple_list):
    return tuple((tuple(g), tuple(g), d) for g, d in zip(separate_list, decouple_list))


def cross_attention_groups(query_list, key_list, decouple_list):
    return tuple((tuple(q), tuple(k), d) for q, k, d in zip(query_list, key_list, decouple_list))


class GroupedCrossAttention(nn.Module):
    """Each group is (query modalities, key modalities, decoupled). When the
    key slice is empty, or ``key_x`` is None (first frame), the group
    attends over its own queries."""

    def __init__(self, embed_dims: int, num_heads: int, groups, drop: float = 0.0):
        super().__init__()
        self.groups = groups
        for gi, (_, _, decoupled) in enumerate(groups):
            dims = embed_dims * (2 if decoupled else 1)
            self.add_module(f"attn_{gi}", MultiheadAttention(dims, num_heads, drop))

    def forward(self, query: torch.Tensor, query_pos: torch.Tensor, sections: Sections,
                fc_before: nn.Module, fc_after: nn.Module,
                key_x: Optional[torch.Tensor] = None,
                key_pos: Optional[torch.Tensor] = None,
                key_sections: Optional[Sections] = None,
                has_value: bool = True,
                attn_bias: Optional[Dict[int, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``has_value`` says whether the reference call site passes a value:
        without one, a decoupled group's value is its feature||pos key
        concatenation, bypassing ``fc_before``. ``attn_bias`` maps a group's
        index to an additive logit bias ``[bs, heads, Nq, Nk]`` for it (not
        applied where the group attends over its own queries for want of
        keys)."""
        out = query
        if key_x is None:
            key_x, key_pos, key_sections = query, query_pos, sections
        for gi, (q_names, k_names, decoupled) in enumerate(self.groups):
            q = section_gather(query, q_names, sections)
            qp = section_gather(query_pos, q_names, sections)
            num_keys = sum(key_sections[m][1] - key_sections[m][0] for m in k_names)
            if num_keys == 0:
                k, kp, v = q, qp, q  # degenerate self-attention
            else:
                k = section_gather(key_x, k_names, key_sections)
                kp = section_gather(key_pos, k_names, key_sections)
                v = k
            attn = getattr(self, f"attn_{gi}")
            bias = attn_bias.get(gi) if attn_bias and num_keys else None
            if decoupled:
                k_cat = torch.cat([k, kp], dim=-1)
                v_in = fc_before(v) if (has_value and num_keys > 0) else k_cat
                res = fc_after(attn(torch.cat([q, qp], dim=-1), key=k_cat, value=v_in,
                                    attn_bias=bias, generator=generator))
            else:
                res = attn(q, key=k, value=v, query_pos=qp, key_pos=kp, attn_bias=bias,
                           generator=generator)
            out = section_scatter(out, res, q_names, sections)
        return out
