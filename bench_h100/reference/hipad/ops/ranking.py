# Frozen copy of hipad_torch/ops/ranking.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""The one ranking the port uses: the ``k`` largest entries along the last
axis in descending order, ties to the lower index, as ``lax.top_k`` and the
JAX package's ``topk_by_argmax`` and stable ``argsort`` order them.
``torch.topk`` promises no order for ties, so this is a stable sort."""

from __future__ import annotations

import torch


def topk(x: torch.Tensor, k: int):
    """-> (values, indices) of the ``k`` largest entries along the last axis."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
