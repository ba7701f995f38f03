"""Batched linear-sum assignment (counterpart of
``hipad_tpu/targets/matching.py``).

Rows are ground-truth slots (padded to a fixed capacity), columns
predictions. Every matrix is solved as the JAX package solves it: entries
that are NaN become +1e3 and all are clipped to +-1e3, invalid rows cost
``PAD_COST`` everywhere, ``R`` virtual columns of ``PAD_COST`` keep the
problem feasible for any row count, and the exact shortest-augmenting-path
Jonker-Volgenant algorithm adds the rows one by one. Rows assigned to a
virtual column come back as -1, as do invalid rows.

A CUDA tensor goes to K3 (``ops/kernels.py:lsa_assign``, one block per
matrix): the result stays on the card and nothing waits for the host. A CPU
tensor takes :func:`assign_plain`, the same algorithm step by step in
torch. Both keep the duals in float64 and take the lowest column on ties,
so they give the same ``col4row`` bit for bit on the same costs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

_CLIP = 1e3
# 30x above the clipped costs: a valid row always prefers a real column.
PAD_COST = 3e4


def _padded(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """``[n, R, C]`` -> ``[n, R, C + R + 1]`` float64: the sentinel column 0
    (zero), the sanitised costs (invalid rows ``PAD_COST``), then ``R``
    virtual columns of ``PAD_COST``."""
    n, R, _ = cost.shape
    c = torch.nan_to_num(cost.detach().float(), nan=_CLIP, posinf=_CLIP, neginf=-_CLIP)
    c = torch.where(row_mask[..., None].bool(), c.clamp(-_CLIP, _CLIP), PAD_COST)
    return torch.cat([c.new_zeros(n, R, 1), c, c.new_full((n, R, R), PAD_COST)],
                     dim=-1).double()


def _lsa_single(cost_p: torch.Tensor) -> torch.Tensor:
    """One padded ``[R, N]`` float64 matrix (column 0 the sentinel) -> ``p
    [N]``: the row held by each column, -1 where free."""
    R, N = cost_p.shape
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=cost_p.device)
    u = torch.zeros(R, dtype=torch.float64, device=cost_p.device)
    v = torch.zeros(N, dtype=torch.float64, device=cost_p.device)
    p = torch.full((N,), -1, dtype=torch.long, device=cost_p.device)
    for i in range(R):
        p[0] = i  # row i enters through the sentinel column
        minv = inf.expand(N).clone()
        used = torch.zeros(N, dtype=torch.bool, device=cost_p.device)
        way = torch.zeros(N, dtype=torch.long, device=cost_p.device)
        j0 = 0
        while True:
            used[j0] = True
            i0 = int(p[j0])
            cur = torch.where(used, inf, cost_p[i0] - u[i0] - v)  # reduced costs
            better = cur < minv
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used, inf, minv)
            j1 = int(torch.argmin(masked))  # the lowest column on ties
            delta = masked[j1]
            # dual update: the used columns' rows gain delta, the used
            # columns lose it, the others' tentative distances shrink by it
            rows = p[used & (p >= 0)]
            u[rows] = u[rows] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
            if int(p[j0]) == -1:
                break
        while j0 != 0:  # augment: walk the alternating path back to the sentinel
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
        p[0] = -1
    return p


def assign_plain(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """K3's plain version: cost ``[n, R, C]``, row_mask ``[n, R]`` bool ->
    col4row ``[n, R]`` int32 on ``cost``'s device, one matrix at a time."""
    n, R, C = cost.shape
    cost_p = _padded(cost, row_mask)
    out = torch.full((n, R), -1, dtype=torch.int32, device=cost.device)
    cols = torch.arange(-1, C + R, device=cost.device)
    for b in range(n):
        p = _lsa_single(cost_p[b])
        held = p >= 0
        out[b, p[held]] = cols[held].int()
    return torch.where(row_mask.bool() & (out < C), out, -1).int()


def assign(cost: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """cost ``[n, R, C]``, row_mask ``[n, R]`` -> col4row ``[n, R]`` int32 on
    ``cost``'s device: the column of each row; -1 for invalid rows and for
    valid rows left without a real column (more valid rows than ``C``)."""
    if cost.is_cuda:
        from ..ops import kernels

        return kernels.lsa_assign(cost.detach().float().contiguous(),
                                  row_mask.bool().contiguous())
    if cost.device.type != "cpu":
        raise ValueError(f"assign: takes CPU or CUDA tensors, got {cost.device}")
    return assign_plain(cost, row_mask)


def assign_many(problems: Sequence) -> List[torch.Tensor]:
    """Several ``(cost [n_i, R_i, C_i], row_mask [n_i, R_i])`` problems ->
    their col4row tensors, one :func:`assign` each."""
    return [assign(cost, mask) for cost, mask in problems]
