"""Training checkpoints (counterpart of ``hipad_tpu/train/checkpoint.py``,
with ``torch.save`` / ``torch.load`` in place of orbax).

A checkpoint is one file per step, ``<ckpt_dir>/<step>/checkpoint.pt``, as
orbax lays out its steps, and holds everything a resumed run needs to
continue as the unbroken one would: the model's parameters and buffers
(BatchNorm running statistics), the AdamW moments and update count, the
step, the temporal banks the next step starts from (one ``BankStates``, a
list of them for gradient accumulation, or None) and the state of the
``torch.Generator`` that dropout and GridMask draw from. ``keep`` newest
steps stay; older ones are deleted, as orbax's ``max_to_keep``.

Tensors load with ``map_location`` to the caller's device, so a checkpoint
written on the card loads on the CPU and back.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from ..models.instance_bank import BankStates, DetBankState, EgoBankState, PlanBankState

FILE = "checkpoint.pt"


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _path(ckpt_dir: str, step: Optional[int]) -> str:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(step), FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint of step {step} under {ckpt_dir}")
    return path


def _banks_out(banks):
    if banks is None:
        return None
    if isinstance(banks, (list, tuple)):
        return [_banks_out(b) for b in banks]
    return {n: {f.name: getattr(getattr(banks, n), f.name).detach()
                for f in dataclasses.fields(getattr(banks, n))}
            for n in ("det", "ego", "plan")}


def _banks_in(payload, device):
    if payload is None:
        return None
    if isinstance(payload, list):
        return [_banks_in(b, device) for b in payload]
    cls = {"det": DetBankState, "ego": EgoBankState, "plan": PlanBankState}
    return BankStates(**{n: cls[n](**{k: v.to(device) for k, v in payload[n].items()})
                         for n in cls})


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module, optimizer,
                    banks: Any = None, generator: Optional[torch.Generator] = None,
                    keep: int = 1) -> str:
    """Write step ``step`` (the file is replaced atomically) and keep the
    ``keep`` newest steps -> the file's path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    d = os.path.join(ckpt_dir, str(step))
    os.makedirs(d, exist_ok=True)
    payload = {
        "step": int(step),
        "model": {k: v.detach() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "banks": _banks_out(banks),
        "generator": None if generator is None else generator.get_state(),
    }
    path = os.path.join(d, FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return path


def _load(ckpt_dir: str, step: Optional[int]) -> Dict[str, Any]:
    # the generator's state is a CPU byte tensor: everything loads to the
    # CPU first and moves to the caller's device where it is used
    return torch.load(_path(os.path.abspath(ckpt_dir), step), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, model: torch.nn.Module, optimizer,
                       generator: Optional[torch.Generator] = None,
                       step: Optional[int] = None) -> Dict[str, Any]:
    """Load step ``step`` (the latest by default) into ``model``,
    ``optimizer`` and ``generator`` in place -> ``{"step", "banks"}``, the
    banks on the model's device."""
    payload = _load(ckpt_dir, step)
    model.load_state_dict(payload["model"])
    device = next(model.parameters()).device
    optimizer.load_state_dict({k: ([t.to(device) for t in v] if isinstance(v, list) else v)
                               for k, v in payload["optimizer"].items()})
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"])
    return {"step": payload["step"], "banks": _banks_in(payload["banks"], device)}


def load_variables(ckpt_dir: str, step: Optional[int] = None,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers of step ``step`` (a ``state_dict``
    on ``device``) for inference-only consumers, without an optimizer."""
    return {k: v.to(device) for k, v in _load(ckpt_dir, step)["model"].items()}


def load_params_only(ckpt_dir: str, model: torch.nn.Module,
                     step: Optional[int] = None) -> List[str]:
    """Warm start (stage 2 from a stage-1 checkpoint): parameters and
    buffers into ``model``, the optimizer left fresh -> the names not
    loaded. As the reference's non-strict load, an entry that the model
    lacks or holds in another shape (stage 1 has no motion head and one
    plan anchor type) is skipped, and the model's entries that the
    checkpoint lacks keep their values."""
    sd = load_variables(ckpt_dir, step)
    own = model.state_dict()
    take = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(take, strict=False)
    return sorted(set(sd) - set(take))
