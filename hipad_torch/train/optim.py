"""Optimizer and LR schedule (counterpart of ``hipad_tpu/train/optim.py``, the
reference recipe): AdamW, lr 2e-4, weight decay 1e-3 on every parameter,
backbone lr x0.5, global-norm gradient clip at 25, linear warm-up from lr/3
over 500 steps, then cosine to lr*1e-3.

The update is ``optax.chain(clip_by_global_norm, adamw)`` written out with
PyTorch's foreach ops, because its semantics differ from ``torch.optim.
AdamW``'s: a parameter with no gradient (``grad is None``) still takes its
moment decay and its weight decay, as a zero gradient does in optax; and
the schedule is read at the update count BEFORE the increment, so the first
update uses lr/3.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

LR = 2e-4
TOTAL_STEPS = 88038
WARMUP_ITERS = 500
WARMUP_RATIO = 1.0 / 3
MIN_LR_RATIO = 1e-3
WEIGHT_DECAY = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8
GRAD_CLIP_NORM = 25.0
BACKBONE_LR_MULT = 0.5


def lr_at(step: int, base_lr: float = LR, total_steps: int = TOTAL_STEPS) -> float:
    """optax ``join_schedules([linear warm-up, cosine decay], [WARMUP_ITERS])``
    with the JAX package's ``lr_schedule(base_lr, total_steps)``."""
    if step < WARMUP_ITERS:
        init = base_lr * WARMUP_RATIO
        return init + (base_lr - init) * (step / WARMUP_ITERS)
    decay_steps = max(total_steps - WARMUP_ITERS, 1)
    t = min(step - WARMUP_ITERS, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    return base_lr * ((1.0 - MIN_LR_RATIO) * cosine + MIN_LR_RATIO)


class AdamW:
    """AdamW over ``named_parameters`` with the recipe above, the schedule
    set by ``base_lr`` and ``total_steps`` (``make_optimizer``'s arguments in
    the JAX package). ``step()`` reads each parameter's ``.grad`` (None
    counts as zero) and returns the global gradient norm taken before
    clipping. ``state_dict()`` holds the moments and the update count."""

    def __init__(self, named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
                 base_lr: float = LR, total_steps: int = TOTAL_STEPS):
        named = list(named_parameters)
        self.base_lr, self.total_steps = base_lr, total_steps
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.mult = [BACKBONE_LR_MULT if n.split(".")[0] == "backbone" else 1.0
                     for n, _ in named]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> Dict[str, object]:
        return {"mu": [t.detach().clone() for t in self.mu],
                "nu": [t.detach().clone() for t in self.nu], "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]):
        for name in ("mu", "nu"):
            src = state[name]
            if len(src) != len(self.params):
                raise ValueError(f"AdamW state {name} has {len(src)} tensors for "
                                 f"{len(self.params)} parameters")
            for dst, t in zip(getattr(self, name), src):
                if dst.shape != t.shape:
                    raise ValueError(f"AdamW state {name}: shape {tuple(t.shape)} for a "
                                     f"parameter of {tuple(dst.shape)}")
                dst.copy_(t)
        self.count = int(state["count"])

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < GRAD_CLIP_NORM, torch.ones_like(norm), GRAD_CLIP_NORM / norm)
        g = torch._foreach_mul(grads, scale)
        torch._foreach_lerp_(self.mu, g, 1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
        lr = lr_at(self.count, self.base_lr, self.total_steps)
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_add_(upd, self.params, alpha=WEIGHT_DECAY)
        for mult in set(self.mult):
            idx = [i for i, m in enumerate(self.mult) if m == mult]
            torch._foreach_add_([self.params[i] for i in idx], [upd[i] for i in idx],
                                alpha=-lr * mult)
        return norm
