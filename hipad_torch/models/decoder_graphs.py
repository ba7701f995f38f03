"""CUDA graphs of the decoder's op runs: the ops between two ``deformable``
ops captured once and replayed, so that the host launches each run's
hundreds of small kernels with one call.

    units = op_units(cfg.operation_order)   # [(lo, hi)]: runs and deformable ops
    cache = GraphCache()
    state = cache.run((lo, hi), fn, state, replay)   # fn: state -> state

A run is a maximal stretch of ``operation_order`` without a ``deformable``
op (7 at ``stage2``). The deformable op stays eager: it waits for the host
and the benchmark reads the sampler's calls. :func:`engages` is the rule,
read from the inputs alone: a run is replayed only on the card, in eval
mode, with grad off, on a warm frame (banks given). Elsewhere every run
goes eager, the same code in the same order.

:class:`GraphCache` keys a run on its op indices, the state's Python values
(sections, the det pruning's live widths and tails, the layer counters),
every input tensor's shape, strides, dtype and device, and the autocast,
inference-mode, deterministic and matmul precision settings. The first
time it sees a key the run goes eager; the second time it is captured
(autocast's weight cache off, so the graph holds its own weight casts),
then replayed; after that it is only replayed. All captures share one
memory pool and replay in the order they were captured.

Inputs: a tensor whose storage belongs to a module parameter or buffer, or
is an output of another graph, is read where it lies; any other is copied
into the graph's own buffer before each replay, unless it already lies
there. Outputs are the graph's static tensors, valid until its next replay:
:meth:`GraphCache.release` clones whatever the caller keeps past the
forward (outputs and banks), and the other graphs, run by run, take them
as they lie.

``counts`` says how often the mechanism engaged, one entry per run and
frame: ``captured`` (then replayed once), ``replayed`` or ``eager``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Sequence, Tuple

import torch

from ..utils.spans import span

Unit = Tuple[int, int]  # [lo, hi) of operation_order


def op_units(order: Sequence[str]) -> List[Unit]:
    """``order`` cut at each ``deformable`` op: the maximal runs of other ops
    and each deformable op alone, as half-open index ranges, in order."""
    units, lo = [], 0
    for i, op in enumerate(order):
        if op == "deformable":
            if i > lo:
                units.append((lo, i))
            units.append((i, i + 1))
            lo = i + 1
    if lo < len(order):
        units.append((lo, len(order)))
    return units


def engages(device: torch.device, training: bool, grad_enabled: bool, warm: bool) -> bool:
    """Whether a frame's runs may be replayed: on the card, in eval mode,
    with grad off, on a warm frame."""
    return device.type == "cuda" and not training and not grad_enabled and warm


# -- the state as a key and a list of tensors ---------------------------------

def flatten(tree) -> Tuple[Any, List[torch.Tensor]]:
    """``tree`` (dicts, lists, tuples and dataclasses of tensors and Python
    values) -> (a hashable spec of its structure and Python values, its
    tensors in order)."""
    leaves: List[torch.Tensor] = []

    def go(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("t",)
        if isinstance(x, dict):
            return ("d", tuple((k, go(v)) for k, v in x.items()))
        if type(x) is list:
            return ("l", tuple(go(v) for v in x))
        if type(x) is tuple:
            return ("u", tuple(go(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return ("c", type(x), tuple((f.name, go(getattr(x, f.name)))
                                        for f in dataclasses.fields(x)))
        return ("v", x)

    return go(tree), leaves


def unflatten(spec, leaves: Iterable[torch.Tensor]):
    """The inverse of :func:`flatten`: new containers, the given tensors."""
    it = iter(leaves)

    def go(s):
        kind = s[0]
        if kind == "t":
            return next(it)
        if kind == "d":
            return {k: go(v) for k, v in s[1]}
        if kind == "l":
            return [go(v) for v in s[1]]
        if kind == "u":
            return tuple(go(v) for v in s[1])
        if kind == "c":
            return s[1](**{k: go(v) for k, v in s[2]})
        return s[1]

    return go(spec)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _span_numel(t: torch.Tensor) -> int:
    """Elements from ``t``'s first to its last, strides and all."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _settings() -> tuple:
    return (torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
            torch.is_inference_mode_enabled(), torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)


class _Input:
    """One input of a graph: the tensor the graph reads, and for a copied
    input the flat buffer that holds it."""

    __slots__ = ("tensor", "flat")

    def __init__(self, x: torch.Tensor, copied: bool):
        self.flat = None
        if copied:
            # the same strides over a buffer of its own, so that the graph
            # computes what the eager run computed on ``x``
            self.flat = torch.empty(_span_numel(x), dtype=x.dtype, device=x.device)
            self.tensor = self.flat.as_strided(x.shape, x.stride(), 0)
            self.load(x)
        else:
            self.tensor = x

    def load(self, x: torch.Tensor) -> bool:
        """Makes the graph read ``x`` (same shape, strides and dtype): a copy
        into the own buffer, or nothing where ``x`` lies where the graph
        reads. False if ``x`` lies elsewhere and the input is not copied."""
        if x.data_ptr() == self.tensor.data_ptr():
            return True
        if self.flat is None:
            return False
        if self.flat.numel():
            self.flat.copy_(x.as_strided((self.flat.numel(),), (1,), x.storage_offset()))
        return True


class _Graph(NamedTuple):
    replay: Callable
    inputs: List[_Input]
    spec_out: Any
    outputs: List[torch.Tensor]


class GraphCache:
    """The captured runs of one decoder, their shared memory pool and the
    engagement counter."""

    def __init__(self):
        self.counts: Dict[str, int] = {"captured": 0, "replayed": 0, "eager": 0}
        self.clear()

    def clear(self):
        """Drops every graph (the parameters were moved or replaced)."""
        self._seen: set = set()
        self._graphs: Dict[Any, _Graph] = {}
        self._owned: set = set()  # storages of the graphs' own buffers and outputs
        self._pool = None

    def run(self, unit: Unit, fn: Callable, state, replay: bool, constants: Callable):
        """``fn(state) -> state`` for the run ``unit``: eager, captured or
        replayed. ``constants()`` -> the tensors whose storages the graphs
        may read in place (the module's parameters and buffers)."""
        if not replay:
            self.counts["eager"] += 1
            return fn(state)
        spec, xs = flatten(state)
        key = (unit, spec, tuple((x.shape, x.stride(), x.dtype, x.device) for x in xs),
               _settings())
        graph = self._graphs.get(key)
        if graph is None and key not in self._seen:
            self._seen.add(key)
            self.counts["eager"] += 1
            return fn(state)
        with span("decoder.graph"):
            if graph is None:
                graph = self._graphs[key] = self._capture(fn, spec, xs, constants)
                self.counts["captured"] += 1
            elif all(inp.load(x) for inp, x in zip(graph.inputs, xs)):
                self.counts["replayed"] += 1
            else:  # an input from elsewhere than at the capture
                self.counts["eager"] += 1
                return fn(state)
            graph.replay()
        return unflatten(graph.spec_out, graph.outputs)

    def _capture(self, fn, spec, xs, constants) -> _Graph:
        fixed = {_storage(t) for t in constants()}
        in_place = fixed | self._owned
        inputs = [_Input(x, copied=_storage(x) not in in_place) for x in xs]

        def body():
            return flatten(fn(unflatten(spec, [inp.tensor for inp in inputs])))

        replay, (spec_out, outputs) = self.capture(body)
        self._owned.update(_storage(inp.flat) for inp in inputs if inp.flat is not None)
        self._owned.update(s for s in map(_storage, outputs) if s not in fixed)
        return _Graph(replay, inputs, spec_out, outputs)

    def capture(self, body: Callable):
        """``body()`` captured as a CUDA graph in the shared pool -> (replay,
        what ``body`` returned: the output spec and the static outputs).
        Autocast's weight cache is off inside: the graph casts the weights
        itself."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a loader pinning memory)
        # do not break this thread's capture
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"), \
                torch.autocast("cuda", dtype=torch.get_autocast_dtype("cuda"),
                               enabled=torch.is_autocast_enabled("cuda"), cache_enabled=False):
            result = body()
        return graph.replay, result

    def release(self, tree):
        """``tree`` with every tensor that lies in a graph's memory cloned:
        what leaves the forward outlives the next replay."""
        if not self._owned:
            return tree
        spec, xs = flatten(tree)
        return unflatten(spec, [x.clone() if _storage(x) in self._owned else x for x in xs])
