"""Data parallelism over processes (counterpart of ``hipad_tpu/parallel/mesh.py``).

HiP-AD's only parallelism is data parallelism. The JAX package expresses
it as one program over the global batch, sharded over a 1-D ``data`` mesh:
its losses are normalised over the global batch, its BatchNorm takes its
statistics over the global batch, and XLA inserts one all-reduce of the
gradients. Here each process runs the step on its local slice of the global
batch, and these helpers make the result that of the global batch:

  * :func:`init` sets up the process group with an explicit ``backend``:
    ``nccl`` for one process per card, ``gloo`` on the CPU and for several
    processes sharing one card;
  * :func:`local_batch` takes a rank's slice of the global batch;
  * ``HiPAD(cfg, group=group)`` makes every ``BatchNorm`` sum its
    statistics over the group (with autograd), as flax does under ``jit``
    over a sharded batch;
  * ``losses.hipad_loss.compute_losses(..., group=group)`` normalises every
    loss over the global batch, so each process computes its share of the
    global loss;
  * :func:`all_reduce_grads` sums the shares' gradients in one flat buffer,
    a parameter without a gradient counting as zero (one collective, as
    XLA's), and :func:`all_reduce_metrics` sums the loss shares, so that
    every rank holds and logs the global values.

``train.train_step.make_train_step(..., group=)`` applies the last three,
on a model built for the same group.
Every process must start from the same parameters: :func:`broadcast_state`
copies rank 0's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the group: ``group`` is None for one process."""

    rank: int = 0
    world: int = 1
    group: Optional[object] = None


def init(backend: str, init_method: str, world_size: int, rank: int) -> DataParallel:
    """``torch.distributed.init_process_group`` with everything explicit
    (``init_method`` such as ``tcp://localhost:<port>``); one process
    (``world_size == 1``) needs no group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world_size == 1:
        return DataParallel()
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return DataParallel(rank=rank, world=world_size, group=dist.group.WORLD)


def shutdown(dp: DataParallel):
    if dp.group is not None:
        dist.destroy_process_group()


def local_batch(batch: Mapping[str, object], rank: int, world: int,
                axis: int = 0) -> Dict[str, object]:
    """Rank ``rank``'s contiguous slice of a global batch along ``axis``
    (1 for the ``[accum, batch, ...]`` layout), as ``shard_batch`` places
    it on the mesh."""
    out = {}
    for k, v in batch.items():
        n = v.shape[axis]
        if n % world:
            raise ValueError(f"{k}: a global batch of {n} does not split over {world} "
                             "processes")
        per = n // world
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(rank * per, (rank + 1) * per)
        out[k] = v[tuple(idx)]
    return out


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, group, src: int = 0):
    """Copy rank ``src``'s parameters and buffers to every process."""
    if group is None:
        return
    for t in model.state_dict().values():
        dist.broadcast(t, src, group=group)


@torch.no_grad()
def all_reduce_grads(params, group):
    """Sum every parameter's gradient over the group in one flat buffer; a
    ``None`` gradient counts as zero and is replaced by the sum."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for p, part in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = part.view_as(p)


@torch.no_grad()
def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The loss shares summed over the group, in one collective: the global
    losses."""
    flat = torch.stack([v.float().reshape(()) for v in metrics.values()])
    dist.all_reduce(flat, group=group)
    return dict(zip(metrics, flat.unbind()))
