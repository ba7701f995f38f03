"""One training step with the temporal banks carried from step to step
(counterpart of ``hipad_tpu/train/train_step.py``: forward in train mode,
every task loss, backward, global-norm clip and the AdamW update), and its
gradient-accumulation form.

    model = init_random(HiPAD(cfg), seed)          # on the card
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    banks = None                                   # the first step starts cold
    for batch in batches:                          # tensors on the model's device
        banks, metrics = step(banks, batch, generator)

``metrics`` holds each loss, ``total_loss`` and ``grad_norm`` (the global
norm of the gradients before clipping), as 0-d tensors. After a step each
parameter's ``.grad`` holds that step's gradient. The banks come back
detached: no autograd graph reaches from one step into the next.

``group=`` (a ``torch.distributed`` process group, ``parallel.mesh``) makes
the step that of the global batch the group's processes hold between them,
as the JAX package's step sharded over its data mesh: every loss normaliser
over the global batch (``compute_losses(..., group=)``), the gradients
summed, and the metrics those of the global batch on every rank. The model
must be built for the same group (``HiPAD(cfg, group=group)``), whose
BatchNorms then take their statistics over the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..losses import hipad_loss
from ..models.common import to_float32
from ..models.detector import META_KEYS, HiPAD
from ..models.instance_bank import BankStates, map_banks
from ..parallel import mesh
from .optim import AdamW


def detach_banks(banks: BankStates) -> BankStates:
    return map_banks(torch.Tensor.detach, banks)


def _micro_step(cfg, model: HiPAD, dtype: torch.dtype, group):
    """-> ``run(banks, batch, generator) -> (new_banks, metrics)``: the
    forward in train mode, the losses and their backward, which adds into
    each ``.grad``. Only this call's activations are live."""

    def run(banks, batch, generator):
        images = batch["images"]
        metas = {k: batch[k] for k in META_KEYS if k in batch}
        data = {k: v for k, v in batch.items() if k != "images"}
        with torch.autocast(images.device.type, dtype=dtype, enabled=dtype != torch.float32):
            outputs, new_banks = model(images, metas, banks, generator=generator,
                                       return_depth=True)
        depth = to_float32(outputs.pop("depth"))
        outputs = to_float32(outputs)
        losses = hipad_loss.compute_losses(cfg, outputs, data, depth_preds=depth, group=group)
        total = hipad_loss.total_loss(losses)
        total.backward()
        metrics: Dict[str, torch.Tensor] = {k: torch.as_tensor(v).detach()
                                            for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return detach_banks(new_banks), metrics

    return run


def _check_group(model: HiPAD, group):
    """The step of a group's global batch needs the model built for that
    group (``HiPAD(cfg, group=group)``: its BatchNorms take their statistics
    over the group's batches)."""
    if model.group is not group:
        raise ValueError(f"the step runs for process group {group!r}, the model was built for "
                         f"{model.group!r}: build it with HiPAD(cfg, group=...)")


def _apply(optimizer: AdamW, metrics, group):
    """All-reduce (with a group), then the AdamW update -> the metrics."""
    if group is not None:
        mesh.all_reduce_grads(optimizer.params, group)
        metrics = mesh.all_reduce_metrics(metrics, group)
    metrics["grad_norm"] = optimizer.step()
    return metrics


def make_train_step(cfg, model: HiPAD, optimizer: AdamW,
                    dtype: torch.dtype = torch.float32, group=None) -> Callable:
    """-> ``step(banks, batch, generator) -> (new_banks, metrics)``.

    ``batch`` is a ``data.synthetic.make_batch``-style dict of tensors on
    the model's device; ``generator`` a ``torch.Generator`` there, which
    GridMask and every dropout draw from. ``dtype=torch.bfloat16`` runs the
    forward under bf16 autocast; its outputs are cast to fp32 before the
    targets and the losses, which always run in fp32. ``group``: this
    process's batch is its slice of the group's global batch.
    """
    _check_group(model, group)
    micro = _micro_step(cfg, model, dtype, group)

    def step(banks: Optional[BankStates], batch: Mapping[str, torch.Tensor],
             generator: torch.Generator):
        model.train()
        optimizer.zero_grad()
        new_banks, metrics = micro(banks, batch, generator)
        return new_banks, _apply(optimizer, metrics, group)

    return step


def make_accum_train_step(cfg, model: HiPAD, optimizer: AdamW, accum_steps: int,
                          dtype: torch.dtype = torch.float32, group=None) -> Callable:
    """Gradient accumulation (``hipad_tpu/train/train_step.py:
    make_accum_train_step``): ``accum_steps`` micro-batches per AdamW update.

    -> ``step(banks, batches, generator) -> (new_banks, metrics)`` with
    ``batches`` a sequence of ``accum_steps`` batch dicts and ``banks`` a
    sequence of as many bank slices (or None: every slice starts cold).
    Each micro-batch is another set of sequences with its own bank slice and
    its own loss normalisers: accumulation widens the global batch, it does
    not advance time. Each micro-step's backward adds its gradient into
    ``.grad`` and frees its activations before the next forward; the sum is
    scaled by ``1 / accum_steps`` and AdamW applies once. BatchNorm's running
    statistics carry from one micro-step to the next, and the metrics are
    the micro-steps' mean (``grad_norm`` that of the mean gradient).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _check_group(model, group)
    micro = _micro_step(cfg, model, dtype, group)
    inv = 1.0 / accum_steps

    def step(banks: Optional[Sequence[Optional[BankStates]]],
             batches: Sequence[Mapping[str, torch.Tensor]], generator: torch.Generator):
        if len(batches) != accum_steps or (banks is not None and len(banks) != accum_steps):
            raise ValueError(f"expected {accum_steps} micro-batches and bank slices, got "
                             f"{len(batches)} and {None if banks is None else len(banks)}")
        model.train()
        optimizer.zero_grad()
        new_banks, sums = [], {}
        for a, batch in enumerate(batches):
            nb, metrics = micro(None if banks is None else banks[a], batch, generator)
            new_banks.append(nb)
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        with torch.no_grad():
            grads = [p.grad for p in optimizer.params if p.grad is not None]
            if accum_steps > 1 and grads:
                torch._foreach_mul_(grads, inv)
        metrics = {k: v * inv for k, v in sums.items()}
        return new_banks, _apply(optimizer, metrics, group)

    return step
