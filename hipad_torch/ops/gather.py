"""The Pallas gather probes P2-P4 of ``tools/probe_pallas_gather.py`` as
row gathers: plain PyTorch versions and the dispatch to the CUDA kernel
``csrc/row_gather.cu``.

Each probe computes ``out[i] = rows[idx[stride * i]]`` over the 1024-element
rows of a table:

  * :func:`probe_a` (P2, ``probe_a``): f32 table ``[N, 8, 128]``, stride 1;
  * :func:`probe_d` (P3, ``probe_d``): bf16 table ``[N/2, 16, 128]``, two
    rows packed per tile. The packed layout is the same bytes as
    ``[N, 1024]`` rows and the Pallas kernel's odd/even select
    ``lo * (1 - m) + hi * m`` is exact for finite values, so it is a bf16
    row gather, stride 1;
  * :func:`probe_c` (P4, ``probe_c``): f32 table ``[N, 8, 128]``, every 8th
    index (the block-index-map gather), stride 8.

Outputs are ``[rows, 8, 128]`` in the table's dtype, as the probes return
them. A CPU table takes :func:`gather_rows_plain`; a CUDA table takes the
kernel (``kernels.gather_rows_*``), which raises on anything it does not
take. Indices must lie in ``[0, N)``: neither the kernel nor the Pallas
probes check them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

ROW = 1024  # elements per gathered row: one (8, 128) f32 block


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor, stride: int) -> torch.Tensor:
    """``table.reshape(N, ROW)[idx[::stride]]`` -> ``[ceil(M / stride), 8, 128]``."""
    rows = table.reshape(-1, ROW)
    return rows[idx[::stride].long()].reshape(-1, 8, 128)


def _gather(kernel: kernels.RowGather, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, kernel.stride)
    return kernel(table.reshape(-1, ROW), idx).reshape(-1, 8, 128)


def probe_a(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P2: idx ``[M]`` int32, table ``[N, 8, 128]`` f32 -> ``[M, 8, 128]``."""
    return _gather(kernels.gather_rows_f32, table, idx)


def probe_d(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P3: idx ``[M]`` int32, table ``[N/2, 16, 128]`` bf16 -> ``[M, 8, 128]``."""
    return _gather(kernels.gather_rows_bf16, table, idx)


def probe_c(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P4: idx ``[M]`` int32, table ``[N, 8, 128]`` f32 -> ``[M/8, 8, 128]``."""
    return _gather(kernels.gather_rows_f32_every8, table, idx)


# probe letter -> (function, table dtype, table layout from [N, ROW] rows, stride)
PROBES = {
    "A": (probe_a, torch.float32, lambda n: (n, 8, 128), 1),
    "D": (probe_d, torch.bfloat16, lambda n: (n // 2, 16, 128), 1),
    "C": (probe_c, torch.float32, lambda n: (n, 8, 128), 8),
}


def make_table(which: str, rows: np.ndarray, device) -> torch.Tensor:
    """The probe's table from ``[N, ROW]`` f32 rows, as its ``prep`` lays it out."""
    _, dtype, shape, _ = PROBES[which]
    t = torch.as_tensor(np.ascontiguousarray(rows, np.float32), device=device)
    return t.to(dtype).reshape(shape(rows.shape[0])).contiguous()
