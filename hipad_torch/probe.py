"""Device-side profile of the training step or the serving frame on one
CUDA card: wall time, device busy time, idle share, kernel launches and the
kernels that take the time.

    python -m hipad_torch.probe [--mode train|frame] [--dtype fp32|bf16]
                                [--config stage2|stage2_serving_det|...]

The config (``stage2()`` unless named) at bs=1 with seeded random
weights, the training step with dropout and GridMask on, the frames and
steps chained as ``chip_smoke.py`` chains them. After 2 warm-up iterations it times 6 on the host clock (a
sync each, profiler off), then profiles 3 more with ``torch.profiler``
(CPU and CUDA activities) and merges the kernels' intervals on the device
timeline. ``idle share`` is ``1 - device busy / unprofiled wall``; the
share inside the profiled window, whose host side the profiler slows, is
printed beside it. The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import time

import torch

FAMILIES = (  # first match wins, on the lower-cased kernel name
    ("K1 coarse_sample", ("coarse_sample_kernel",)),
    ("K1-bwd sample blocks", ("interp_sample_camsum_bwd_samples",)),
    ("K1-bwd tile blocks", ("interp_sample_camsum_bwd_tiles",)),
    ("K2 patch_sample", ("patch_sample_kernel",)),
    ("K2-bwd patch_sample_bwd", ("patch_sample_bwd",)),
    ("sampler glue cam_select", ("cam_select",)),
    ("sampler glue point_sum", ("point_sum",)),
    ("P2-P4 row_gather", ("row_gather",)),
    ("K3 lsa_assign", ("lsa_assign",)),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "dgrad", "wgrad", "fprop")),
    ("GEMM", ("gemm", "cutlass", "xmma", "sm90", "cublas")),
    ("attention", ("attention", "fmha", "flash")),
    ("norm", ("norm",)),
    ("reduce", ("reduce",)),
    ("sort / top-k / scan", ("sort", "topk", "scan", "radix")),
    ("foreach (optimizer)", ("foreach", "multi_tensor")),
    ("index / scatter / gather", ("index", "scatter", "gather")),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat")),
)


CONFIGS = ("stage2", "stage2_serving", "stage2_serving_det", "stage2_serving_topk",
           "stage2_serving_prune")


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _merged_busy(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("train", "frame"), default="train")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--config", choices=CONFIGS, default="stage2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe measures a CUDA card; torch.cuda.is_available() is false")
    from torch.profiler import ProfilerActivity, profile

    from .configs import model as configs
    from .data import synthetic
    from .models.detector import META_KEYS, HiPAD
    from .train.optim import AdamW
    from .train.train_step import make_train_step
    from .weights import init_random

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cfg = getattr(configs, args.config)()
    model = init_random(HiPAD(cfg, device=dev), 0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic.make_batch(cfg, 1, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    state = {"banks": None, "i": 0}

    if args.mode == "train":
        step = make_train_step(cfg, model, AdamW(model.named_parameters()), dtype=dtype)

        def run():
            b = dict(batch, timestamp=batch["timestamp"] + 0.5 * state["i"],
                     images=batch["images"] + 1e-3 * state["i"])
            state["banks"], _ = step(state["banks"], b, gen)
            state["i"] += 1
    else:
        metas = {k: batch[k] for k in META_KEYS}

        def run():
            m = dict(metas, timestamp=metas["timestamp"] + 0.5 * state["i"])
            with torch.no_grad(), torch.autocast("cuda", dtype=dtype,
                                                 enabled=dtype != torch.float32):
                _, state["banks"] = model(batch["images"] + 1e-3 * state["i"], m,
                                          state["banks"])
            state["i"] += 1

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(6):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)

    n_prof = 3
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            run()
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t) * 1e3 / n_prof

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _merged_busy([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / n_prof
    fam = collections.Counter()
    fam_n = collections.Counter()
    for e in kernels:
        f = _family(e.name)
        fam[f] += (e.time_range.end - e.time_range.start) / 1e3 / n_prof
        fam_n[f] += 1
    per = args.mode
    result = {
        "card": card, "config": args.config, "mode": per, "dtype": args.dtype, "wall_ms": wall,
        "wall_ms_all": walls, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "idle_share_in_profiled_window": 1.0 - busy / prof_wall,
        "profiled_wall_ms": prof_wall,
        "launches": len(kernels) / n_prof,
        "device_ms_by_family": {k: round(v, 3) for k, v in fam.most_common()},
        "launches_by_family": {k: fam_n[k] / n_prof for k, _ in fam.most_common()},
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(f"[probe] {per} {args.config} bs=1 {args.dtype} on {card}: wall {wall:.2f} ms (median of 6, "
          f"profiler off), device busy {busy:.2f} ms, idle share {result['idle_share']:.3f} "
          f"({result['idle_share_in_profiled_window']:.3f} inside the profiled window of "
          f"{prof_wall:.2f} ms), {result['launches']:.0f} kernel launches per {per}")
    for k, v in fam.most_common():
        print(f"[probe]   {k}: {v:.3f} ms, {fam_n[k] / n_prof:.0f} launches")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
