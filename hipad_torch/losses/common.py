"""Elementary weighted losses (counterpart of ``hipad_tpu/losses/common.py``).

mmdet conventions: ``weight`` multiplies elementwise, ``avg_factor``
replaces the mean's denominator when given. Every function returns a
scalar.

Data parallelism: given ``group`` (a ``torch.distributed`` process group;
``None``: this process alone), each process computes its share of the loss
of the global batch that the JAX package normalises as one
(``hipad_tpu/losses/hipad_loss.py:14-16``). A count that normalises a loss
goes through :func:`global_sum` before it is clamped or divided by, and a
mean over the local elements is divided by the number of processes (they
hold equal local batches). The shares of all processes then sum to the
global loss, and the sum of their gradients is its gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def world_size(group) -> int:
    """Processes that share the global batch (1 for ``group=None``)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A normaliser summed over the processes of ``group`` (no gradient flows
    through it)."""
    if group is None:
        return x
    import torch.distributed as dist

    y = torch.as_tensor(x).detach().clone()
    dist.all_reduce(y, group=group)
    return y


def local_mean(loss: torch.Tensor, group=None) -> torch.Tensor:
    """This process's share of the mean over the global batch's elements."""
    n = world_size(group)
    return loss.mean() if n == 1 else loss.mean() / n


def _reduce(loss: torch.Tensor, weight, avg_factor, group=None) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return local_mean(loss, group) if loss.numel() else loss.new_zeros(())
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype,
                                                    device=loss.device), min=1e-12)


def l1_loss(pred, target, weight=None, avg_factor=None, loss_weight=1.0, group=None):
    return _reduce((pred - target).abs(), weight, avg_factor, group) * loss_weight


def smooth_l1_loss(pred, target, beta=1.0, weight=None, avg_factor=None, loss_weight=1.0,
                   group=None):
    d = (pred - target).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return _reduce(loss, weight, avg_factor, group) * loss_weight


def _bce(pred, target):
    return torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def bce_with_logits(pred, target, weight=None, avg_factor=None, loss_weight=1.0, group=None):
    """Sigmoid cross-entropy."""
    return _reduce(_bce(pred, target), weight, avg_factor, group) * loss_weight


def sigmoid_focal_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                       alpha: float = 0.25, gamma: float = 2.0,
                       weight: Optional[torch.Tensor] = None, avg_factor=None,
                       loss_weight: float = 1.0, group=None):
    """mmdet sigmoid focal loss: logits ``[N, num_classes]``, ``target [N]``
    int labels in ``[0, num_classes]`` (``num_classes`` = background),
    ``weight [N]``."""
    t = F.one_hot(target.long(), num_classes + 1)[..., :num_classes].to(logits.dtype)
    loss = _focal(logits, t, alpha, gamma)
    if weight is not None:
        loss = loss * weight[..., None]
    if avg_factor is None:
        return local_mean(loss, group) * loss_weight
    return _reduce(loss, None, avg_factor) * loss_weight


def _focal(logits, t, alpha, gamma):
    p = torch.sigmoid(logits)
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    return alpha_t * (1.0 - p_t) ** gamma * _bce(logits, t)


def binary_focal_loss(logits, target, alpha: float = 0.25, gamma: float = 2.0,
                      weight=None, avg_factor=None, loss_weight: float = 1.0, group=None):
    """Focal loss with one binary channel per slot; ``target`` a float {0, 1}
    tensor of the logits' shape."""
    return _reduce(_focal(logits, target, alpha, gamma), weight, avg_factor,
                   group) * loss_weight


def gaussian_focal_loss(pred_sigmoid, target, alpha: float = 2.0, gamma: float = 4.0,
                        weight=None, avg_factor=None, loss_weight: float = 1.0,
                        eps: float = 1e-12, group=None):
    """mmdet ``GaussianFocalLoss`` on a probability ``pred_sigmoid``."""
    pos = -torch.log(pred_sigmoid + eps) * (1 - pred_sigmoid) ** alpha * (target == 1)
    neg = (-torch.log(1 - pred_sigmoid + eps) * pred_sigmoid ** alpha
           * (1 - target) ** gamma * (target != 1))
    return _reduce(pos + neg, weight, avg_factor, group) * loss_weight
