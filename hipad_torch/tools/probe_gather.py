"""The gather probes P2-P4 on one CUDA card: the counterpart of
``tools/probe_pallas_gather.py`` (same command line, seeded data and
``correct=`` line).

    python -m hipad_torch.tools.probe_gather [A|D|C] [time]

A (P2) gathers f32 rows of a ``[N, 8, 128]`` table, D (P3) bf16 rows of a
packed ``[N/2, 16, 128]`` table, C (P4) every 8th index's row; each
1024-element row is one output row (``hipad_torch/ops/gather.py``). ``N =
1792`` table rows, ``M = PROBE_M`` (default 8192) indices, data from
``numpy.random.RandomState(0)`` as the TPU tool draws it. ``correct=``
holds the output to the table's own rows exactly (the kernel copies
bytes); the TPU tool's ``allclose(atol=1e-2)`` against the f32 rows
cannot pass for bf16 rows above 4 in magnitude, which bf16 rounds by up
to 0.0156. With ``time`` it prints the median of 16 CUDA-event timings
of one call each (the Python launch included), with the index set
changing from call to call.

``main(argv, device="cpu")`` runs the plain versions instead (no timing).
"""

from __future__ import annotations

import os
import statistics
import sys

import numpy as np
import torch

from ..ops import gather

N = 1792  # table rows, as the TPU tool sizes them
M = int(os.environ.get("PROBE_M", 8192))  # indices per call


def run(which: str, device="cuda", time_it: bool = False):
    """-> (output ``[rows, 1024]`` as float32 numpy, reference, correct,
    median ms or None)."""
    which = which.upper()
    fn, dtype, _, stride = gather.PROBES[which]
    dev = torch.device(device)
    if dev.type != "cuda" and time_it:
        raise ValueError("timing measures a CUDA card; the CPU runs the plain versions")
    rng = np.random.RandomState(0)
    rows = rng.randn(N, gather.ROW).astype(np.float32)
    idx_np = rng.randint(0, N, M).astype(np.int32)
    table = gather.make_table(which, rows, dev)
    idx = torch.as_tensor(idx_np, device=dev)
    out = fn(idx, table).reshape(-1, gather.ROW).float().cpu().numpy()
    ref = torch.as_tensor(rows).to(dtype).float().numpy()[idx_np[::stride]]
    correct = out.shape == ref.shape and bool(np.array_equal(out, ref))
    ms = None
    if time_it:
        idxs = [torch.as_tensor(rng.randint(0, N, M).astype(np.int32), device=dev)
                for _ in range(8)]
        fn(idxs[0], table)
        times = []
        for k in range(16):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(idxs[k % 8], table)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
    return out, ref, correct, ms


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    which = (argv[0] if argv else "A").upper()
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the probe runs on a CUDA card; torch.cuda.is_available() is false")
    _, ref, correct, ms = run(which, device, time_it="time" in argv)
    print(f"probe {which}: compiled+ran, correct={correct}")
    if ms is not None:
        print(f"median {ms:.4f} ms for {ref.shape[0]} rows (CUDA events, median of 16, "
              f"{torch.cuda.get_device_name(0)})")
    return correct


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
