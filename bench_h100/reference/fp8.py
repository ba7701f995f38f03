"""The control's precision: fp8 (e4m3) operands for the products that a
lower-precision program would take on the tensor cores (Linear, the
convolutions, attention's two products), each operand scaled by its own
absolute maximum into e4m3's range, rounded, and scaled back; the product
itself in fp32. Geometry and the sampler's interpolation stay in fp32, as
in the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale (its absolute maximum to 448),
    in fp32; the gradient passes straight through to ``x``."""
    if not (torch.is_tensor(x) and x.is_floating_point()):
        return x
    x = x.float()
    d = x.detach()
    scale = d.abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (d / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - d)


# function -> the positions of its operands
OPERANDS = {
    F.linear: (0, 1),
    F.conv2d: (0, 1),
    torch.matmul: (0, 1),
    torch.Tensor.__matmul__: (0, 1),
    F.scaled_dot_product_attention: (0, 1, 2),
}


class Fp8Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pos = OPERANDS.get(func)
        if pos is not None:
            args = tuple(round_fp8(a) if i in pos else a for i, a in enumerate(args))
        return func(*args, **kwargs)
