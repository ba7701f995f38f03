"""One training step with the temporal banks carried from step to step
(counterpart of ``hipad_tpu/train/train_step.py``: forward in train mode,
every task loss, backward, global-norm clip and the AdamW update).

    model = init_random(HiPAD(cfg), seed)          # on the card
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    banks = None                                   # the first step starts cold
    for batch in batches:                          # tensors on the model's device
        banks, metrics = step(banks, batch, generator)

``metrics`` holds each loss, ``total_loss`` and ``grad_norm`` (the global
norm of the gradients before clipping), as 0-d tensors. After a step each
parameter's ``.grad`` holds that step's gradient. The banks come back
detached: no autograd graph reaches from one step into the next.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch

from ..losses import hipad_loss
from ..models.detector import META_KEYS, HiPAD
from ..models.instance_bank import BankStates
from .optim import AdamW


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def detach_banks(banks: BankStates) -> BankStates:
    return BankStates(*(dataclasses.replace(
        s, **{f.name: getattr(s, f.name).detach() for f in dataclasses.fields(s)})
        for s in (banks.det, banks.ego, banks.plan)))


def make_train_step(cfg, model: HiPAD, optimizer: AdamW,
                    dtype: torch.dtype = torch.float32) -> Callable:
    """-> ``step(banks, batch, generator) -> (new_banks, metrics)``.

    ``batch`` is a ``data.synthetic.make_batch``-style dict of tensors on
    the model's device; ``generator`` a ``torch.Generator`` there, which
    GridMask and every dropout draw from. ``dtype=torch.bfloat16`` runs the
    forward under bf16 autocast; its outputs are cast to fp32 before the
    targets and the losses, which always run in fp32.
    """

    def step(banks: Optional[BankStates], batch: Mapping[str, torch.Tensor],
             generator: torch.Generator):
        images = batch["images"]
        metas = {k: batch[k] for k in META_KEYS if k in batch}
        data = {k: v for k, v in batch.items() if k != "images"}
        model.train()
        optimizer.zero_grad()
        with torch.autocast(images.device.type, dtype=dtype, enabled=dtype != torch.float32):
            outputs, new_banks = model(images, metas, banks, generator=generator,
                                       return_depth=True)
        depth = _to_f32(outputs.pop("depth"))
        outputs = _to_f32(outputs)
        losses = hipad_loss.compute_losses(cfg, outputs, data, depth_preds=depth)
        total = hipad_loss.total_loss(losses)
        total.backward()
        grad_norm = optimizer.step()
        metrics: Dict[str, torch.Tensor] = {k: torch.as_tensor(v).detach()
                                            for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return detach_banks(new_banks), metrics

    return step
