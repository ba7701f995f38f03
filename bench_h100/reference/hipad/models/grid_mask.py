# Frozen copy of hipad_torch/models/grid_mask.py at commit 795f982 for the benchmark's plain
# reference; see bench_h100/reference/__init__.py for the departures.
"""GridMask image augmentation (counterpart of
``hipad_tpu/models/grid_mask.py``): one stripe pattern for the whole batch,
pixels on a horizontal OR vertical stripe kept, the rest zeroed, applied
with probability ``prob``.

Split into a pure function of the pattern's four scalars, so that a test
can hand both packages the same ones, and their draw from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draw_grid_mask(generator: torch.Generator, height: int,
                   prob: float = 0.7) -> Tuple[int, int, int, bool]:
    """(d, st_h, st_w, apply) as the JAX package draws them: the period
    ``d`` uniform in [2, height), the two phases uniform in [0, d), and
    ``apply`` with probability ``prob``."""
    dev = generator.device

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=generator, device=dev))

    apply = float(torch.rand((), generator=generator, device=dev)) < prob
    d = randint(2, height)
    return d, randint(0, d), randint(0, d), apply


def grid_mask(images: torch.Tensor, d: int, st_h: int, st_w: int, apply: bool,
              ratio: float = 0.5) -> torch.Tensor:
    """GridMask on ``[..., H, W, C]`` images with period ``d``, stripe phases
    ``st_h, st_w``; the identity unless ``apply``. The reference builds the
    pattern on a 1.5x canvas and centre-crops it, which shifts the phase by
    ``(floor(1.5 * size) - size) // 2`` per axis."""
    if not apply:
        return images
    h, w = images.shape[-3], images.shape[-2]
    length = min(max(int(d * ratio + 0.5), 1), d - 1)
    ph = (int(1.5 * h) - h) // 2
    pw = (int(1.5 * w) - w) // 2
    rows = torch.arange(h, device=images.device)[:, None]
    cols = torch.arange(w, device=images.device)[None, :]
    keep = (torch.remainder(rows + ph - st_h, d) < length) | \
        (torch.remainder(cols + pw - st_w, d) < length)
    return images * keep.to(images.dtype)[..., None]
