"""Batched linear-sum assignment on the host (counterpart of
``hipad_tpu/targets/matching.py``, which solves on the device with a
Jonker-Volgenant loop).

The port solves with ``scipy.optimize.linear_sum_assignment``, as the
reference does. Rows are ground-truth slots, columns predictions; padded
rows come back as -1. Costs are sanitised as the JAX package sanitises
them (non-finite -> +-1e3, clipped to +-1e3), so both solve the same
problem. :func:`assign_many` takes every cost matrix of a training step
and copies them to the host in ONE transfer.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

_CLIP = 1e3


def _solve(cost: np.ndarray, row_mask: np.ndarray) -> np.ndarray:
    """cost [bs, R, C] float, row_mask [bs, R] bool -> col4row [bs, R] int32."""
    bs, R, C = cost.shape
    cost = np.clip(np.nan_to_num(cost.astype(np.float64), nan=_CLIP, posinf=_CLIP,
                                 neginf=-_CLIP), -_CLIP, _CLIP)
    out = np.full((bs, R), -1, np.int32)
    for b in range(bs):
        rows = np.flatnonzero(row_mask[b])
        if rows.size == 0:
            continue
        r, c = linear_sum_assignment(cost[b, rows])
        out[b, rows[r]] = c
    return out


def assign(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """cost ``[bs, R, C]``, row_mask ``[bs, R]`` bool -> col4row ``[bs, R]``
    int32 on ``cost``'s device; -1 for invalid rows (and for valid rows
    beyond ``C``, which scipy leaves unassigned)."""
    return assign_many([(cost, row_mask)])[0]


def assign_many(problems: Sequence) -> List[torch.Tensor]:
    """Several ``(cost [bs_i, R_i, C_i], row_mask [bs_i, R_i])`` problems,
    copied to the host together in one transfer -> their col4row tensors."""
    dev = problems[0][0].device
    flat = torch.cat([t.detach().float().reshape(-1) for c, m in problems for t in (c, m)])
    host = flat.cpu().numpy()
    out, ofs = [], 0
    for cost, mask in problems:
        n, k = cost.numel(), mask.numel()
        c = host[ofs:ofs + n].reshape(cost.shape)
        m = host[ofs + n:ofs + n + k].reshape(mask.shape) != 0
        ofs += n + k
        out.append(torch.from_numpy(_solve(c, m)).to(dev))
    return out
