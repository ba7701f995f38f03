"""Sequence-streaming batch sampler + host data loader.

TPU rework of ``GroupInBatchSampler`` (`datasets/samplers/
group_in_batch_sampler.py:48-178`, from SOLOFusion): each of the
``global_batch_size`` slots streams the frames of its own sequence in order,
refilling from a shuffled infinite iterator over sequence groups, with
*per-sequence consistent augmentation*. This is what makes the temporal
instance banks valid during iteration-based training.

Multi-host note: the reference shards slots by DDP rank. Under pjit the
global batch is assembled per host with ``jax.process_index()`` strides —
slot s of this host is global slot ``rank * per_host + s`` — and sharded over
the mesh, which reproduces the same slot<->device mapping.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import pipelines as pp


class GroupStreamSampler:
    """Yields per-step lists of dataset request dicts, one per batch slot."""

    def __init__(
        self,
        flags: np.ndarray,
        batch_size: int,
        seed: int = 0,
        data_aug_conf: Dict = pp.DATA_AUG_CONF,
        keep_consistent_seq_aug: bool = True,
        num_cams: int = 6,
    ):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.data_aug_conf = data_aug_conf
        self.keep_consistent = keep_consistent_seq_aug
        self.num_cams = num_cams

        self.groups = np.unique(self.flags)
        self.group_indices = {g: np.where(self.flags == g)[0] for g in self.groups}
        self._group_iter = self._infinite_groups()
        # per-slot state
        self._slot_frames: List[Optional[Iterator]] = [None] * batch_size
        self._slot_aug: List[Optional[Dict]] = [None] * batch_size
        self._slot_distortion: List[Optional[List[Dict]]] = [None] * batch_size

    def _infinite_groups(self):
        while True:
            order = self.rng.permutation(self.groups)
            for g in order:
                yield g

    def _refill(self, slot: int):
        g = next(self._group_iter)
        self._slot_frames[slot] = iter(self.group_indices[g].tolist())
        self._slot_group = getattr(self, "_slot_group", [None] * self.batch_size)
        self._slot_epoch = getattr(self, "_slot_epoch", [0] * self.batch_size)
        self._slot_group[slot] = int(g)
        self._slot_epoch[slot] += 1
        if self.keep_consistent:
            self._slot_aug[slot] = pp.sample_aug_config(self.data_aug_conf, self.rng)
            self._slot_distortion[slot] = pp.sample_distortion_params(
                self.rng, self.num_cams
            )

    def __iter__(self):
        return self

    def __next__(self) -> List[Dict]:
        batch = []
        for s in range(self.batch_size):
            while True:
                if self._slot_frames[s] is None:
                    self._refill(s)
                try:
                    idx = next(self._slot_frames[s])
                    break
                except StopIteration:
                    self._slot_frames[s] = None
            aug = (self._slot_aug[s] if self.keep_consistent
                   else pp.sample_aug_config(self.data_aug_conf, self.rng))
            batch.append({"idx": idx, "aug_config": aug,
                          "distortion": self._slot_distortion[s],
                          "group": self._slot_group[s],
                          "epoch": self._slot_epoch[s]})
        return batch


def collate(frames: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-frame dicts into a batch (all values already fixed-shape)."""
    out = {}
    for k in frames[0]:
        v0 = frames[0][k]
        if isinstance(v0, (str, bytes)) or v0 is None:
            out[k] = [f[k] for f in frames]
        else:
            out[k] = np.stack([np.asarray(f[k]) for f in frames])
    return out


class TrainLoader:
    """Minimal host loader: sampler -> dataset -> collate (optionally with a
    thread-pool prefetcher)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 0, prefetch: int = 2,
                 rank: int = 0, world: int = 1):
        """``batch_size`` is GLOBAL. Multi-host (``world > 1``): every host
        builds the identically-seeded global sampler and loads only its
        contiguous slot slice ``[rank*per_host, (rank+1)*per_host)`` — the
        deterministic counterpart of the reference's per-DDP-rank slot shard
        (`group_in_batch_sampler.py:123-171`), matching the process order
        ``jax.make_array_from_process_local_data`` assembles shards in.
        """
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} % world {world} != 0")
        self.dataset = dataset
        self.sampler = GroupStreamSampler(
            dataset.flag, batch_size, seed=seed,
            data_aug_conf=dataset.data_aug_conf,
            keep_consistent_seq_aug=dataset.keep_consistent_seq_aug,
        )
        per_host = batch_size // world
        self._lo, self._hi = rank * per_host, (rank + 1) * per_host
        self.num_workers = num_workers
        self.prefetch = prefetch

    def _local(self, reqs):
        return reqs[self._lo:self._hi]

    def __iter__(self):
        if self.num_workers <= 0:
            for reqs in self.sampler:
                yield collate([self.dataset[r] for r in self._local(reqs)])
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = []
            it = iter(self.sampler)
            for _ in range(self.prefetch):
                reqs = self._local(next(it))
                pending.append(pool.map(self.dataset.__getitem__, reqs))
            while True:
                done = pending.pop(0)
                reqs = self._local(next(it))
                pending.append(pool.map(self.dataset.__getitem__, reqs))
                yield collate(list(done))
