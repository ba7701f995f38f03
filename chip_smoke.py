#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR   # phases 1-2, then the comparison below
    python3 chip_smoke.py --graphs        # phases 1-2, then 4g alone

Phases, one printed line (or a few) each; any failure exits non-zero:

  1. environment: torch/CUDA versions and the card's name and power limit
     (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
  2. build the kernels from ``hipad_torch/csrc/*.cu``, one nvcc per source,
     all started together;
  3. each forward kernel (K1, K2) against its plain PyTorch version on the
     card, at the stage-2 shapes the main path gives it, fp32 and bf16
     feature maps; timed against the plain version and against
     ``F.grid_sample``, which computes a related but not the same function:
     device time (calls queued back to back behind a sleep kernel that
     outlasts their queueing) and, beside
     it, the time of one call with its Python launch path;
  3b. each backward kernel (K1-bwd, K2-bwd) against ``torch.autograd.grad``
     of the plain version at the same shapes, every gradient output, fp32
     and bf16 maps, bs=1 and 2, coordinates on the hat weights' kinks
     included; K1-bwd also on ``stage2_r101_2x()``'s 44x80 and 88x160 maps;
     both also on the largest calls of one stage-2 training step, recorded
     as the step makes them (fp32, and with bf16 maps), their plans printed;
     timed the same way. Each wrapper has one design, the binned scatter
     (``csrc/bin_scatter.cuh``), deterministic: called twice on the same
     inputs, its outputs held equal bit for bit, then twice under
     ``torch.use_deterministic_algorithms(True)``, held bit for bit to those
     calls. K1-bwd's record is per launch: one launch a coarse level, its
     times and bound the mean of the two levels';
  4. the serving path: ``stage2()`` with seeded random weights, bs=1, 2
     warm-up and 8 timed frames with the banks chained and a new image per
     frame, in fp32 and then under bf16 autocast; finite outputs; every
     kernel's launch count over those frames; the bf16 frames 0 and 1's
     waypoints within the bf16/fp32 spread the CPU test allows on each of
     the fp32 frames'; then frame 0 once more on the CPU (plain path, fp32)
     against the card's fp32 frame 0;
  4g. the decoder's op runs as CUDA graphs (``[graphs]``): ``stage2()`` and
     ``stage2_serving_det()`` at bs=1, bf16 and fp32, a cold frame and 8
     warm ones, each through the decoder (its runs replayed from the third
     frame on) and through ``forward_eager`` (every op eager) from the same
     feature maps and banks: outputs and banks bit for bit (or each
     differing leaf printed, held within ``E2E_RTOL``), the graph counter
     frame by frame, every frame's outputs and banks unchanged after the
     later frames; then one warm bf16 frame with post-processing under the
     sync debug mode (60 waits at ``stage2``), graphed and eager frames in
     turns (host clock), one of each profiled (host launch calls, device
     kernels, busy) and the graphed and eager frames' host ms by span;
  5. the training path: the stage-2 training step at bs=1 with seeded
     random weights, dropout 0.1 and GridMask on, 2 warm-up and 4 timed
     steps with the banks chained, fp32 and then bf16 autocast; finite
     losses and gradient norm, step time, peak memory, every kernel's launch
     count against the op program's; then, under torch's deterministic
     flag, one fp32 and one bf16 step twice from one saved state
     (parameters, AdamW state, banks, generator): losses, every gradient
     leaf, the parameters after the update and the new banks held equal bit
     for bit, and the step with the flag off and on in turns with one
     profiled step of each (device busy, launches); then 2 rounds of one
     fp32 and one bf16 step in turn, which compare the two on the host
     clock; then step 0 without dropout and GridMask on the card and on the
     CPU plain path, loss by loss;
  5f. (right after 5) K3, the batched assignment solver: the det and map
     cost matrices of a stage-2 fp32 step at bs=1 and bs=2, and seeded
     costs with exact ties, NaN and +-inf entries, an all-invalid matrix,
     more valid rows than columns and a matrix too large to stage in
     shared memory; 9 problems of mixed shapes in one ``assign_many`` call
     (more than the 8 a launch takes, register and strip kernels), and
     ``[8, 64, 6000]`` (N = 6,065) and ``[1, 32, 20000]`` (N = 20,033), past
     the registers' 2,048 padded columns; K3 against ``assign_plain`` on the
     card, bit for bit, and against scipy on the host (totals), with each
     matrix's inner iterations; one K3 launch per step; K3's device time
     per step and per iteration of the longest chain, time per call, the
     plain version's time and scipy's with the device-to-host copy, its
     bound (bytes or fp64 operations); the step's synchronizing calls by call site
     (``torch.cuda.set_sync_debug_mode("warn")``), none of them the
     matcher's, and ``assign_many`` under ``set_sync_debug_mode("error")``;
  5b. the training CLI, ``python -m hipad_torch.tools.train`` (its
     ``main``, which runs under torch's deterministic flag), at stage 2 in
     bf16: 4 optimizer steps of 2 micro-batches unbroken (launches per step,
     step time, peak memory), then ``--resume`` from its step-2 checkpoint:
     the restored state, the parameters after step 3 and steps 3 and 4's
     metrics held bit for bit against the unbroken run's;
  5e. (right after 5b, on its step-4 checkpoint) the open-loop eval over a
     ``tools/make_synthetic_val.py`` split with seeded 1600x900 JPEGs: the
     runner in fp32, streaming (frame 0 against a direct forward +
     ``post_process``, bit for bit) and with two batch slots (held against
     streaming record by record, rel 1e-4, abs 1e-5); then ``python -m
     hipad_torch.tools.test`` (its ``main``, bf16) streaming (24 K1 and 24
     K2 launches per frame), with ``--batch-slots 2`` and as two ranks (held
     against one rank); frames, wall, ``fps_wall`` and the loader's share;
     then ``python -m hipad_torch.tools.train --ann-file`` for 2 steps with
     an eval;
  5c. one ``stage1()`` training step, its kernel launches;
  5d. two processes over gloo on the one card, each a stage-2 step at bs=1,
     against one process at bs=2: step-0 metrics, and the parameters after
     the update equal on both ranks;
  6. the serving frame: ``stage2_serving_det()`` (keypoint top-k, det-query
     pruning), bs=1, 2 warm-up and 8 timed chained frames with
     ``post_process_arrays``, fp32 then bf16 autocast; finite outputs; K1/K2
     launches against the op program; frame 0 post-processed on the card
     and on the CPU plain path with every selection recorded (keypoints,
     sorts, top-k): a pick that differs is printed with its score gap and
     fails above the tolerance, and the outputs are held key by key where
     the selections agree; under torch's deterministic flag, frames 0 and 1
     (fp32) and frame 0 (bf16) each twice from the same banks, held bit for
     bit; then
     stage2 and serving frames in turns (informational);
  7. the agent: ``AgentCore(stage2_serving_det())`` in fp32 over the fake
     simulator's 6 x 1600x900 uint8 cameras, JPEG q20 and the native
     resize/crop, 2 warm-up and 10 ticks; every control finite and clipped;
     the median host preprocessing and upload+inference per tick;
  7b. the closed loop (``[closed-loop]``): the CARLA leaderboard agent
     ``HiPADTorchAgent`` through its stub with
     ``setup("+smoke+config=stage2_serving_det")``, its sensors and 12
     ticks of leaderboard-format input (six BGRA 1600x900 cameras, IMU,
     GNSS, speedometer) on a straight route: controls finite and clipped,
     ``metric_info.json``, a composite every 4 ticks; then
     ``closed_loop_serving_bench.main`` for 30 ticks of
     ``stage2_serving_det`` (ticks/s, per-phase ms) and
     ``serving_error_sweep.main`` decoder-only at full width, every row
     (deltas finite, each row's K1 and K2 or K2-lk launches);
  8. the gather probes P2-P4 at the probe tool's shapes: the tool's own
     timed run (its launches), then each kernel against its plain version
     (equal: a copy), and its device time (calls queued back to back)
     against the plain version's and ``torch.index_select``'s, in turns;
  9. the decoder's model options (``[options]``): K2's and K2-bwd's
     level-k variants (``sampler_level_k``) against their plain versions
     and autograd of them at the det task's stage-2 shapes (cam_k 2,
     level_k 1, renormalised or not, fp32 and bf16 maps), timed as in
     phases 3 and 3b; one det deformable op of ``stage2(sampler=
     "reference")``, which the card runs through K1 and K2 with every camera
     kept, against the oracle run plainly on the card; then chained frames
     (2 warm-up, 8 timed, fp32 and bf16) of A = ``stage2_serving`` with the
     level top-k, both attention masks and the per-point embeds in the
     deformable weights heads, B = ``stage2`` with the concat point
     expansion (5,781 joint queries) and C = ``stage2(sampler="reference")``,
     each kernel's launches against the op program and frame 0 against the
     CPU plain path as in phase 6 (B and C at 2 decoder layers there); and
     one training step of A against the CPU, loss by loss, on the card with
     torch's deterministic flag off and on.

The line before the last is a JSON object with one entry per kernel (its
device time and its time per call, its plain version's, the bound the card's
peaks set for the bytes and operations these inputs need, the nearest
library call's, its launches on its own path and on every path that ran
it); the last is ``{"ok": true,
"device": {...}}``. There is no CPU fallback: without a CUDA device the
script exits non-zero and prints no result. ``CUBLAS_WORKSPACE_CONFIG`` is
set to ``:4096:8`` (where the environment has no value) before torch is
imported: torch's deterministic flag needs it before the first cuBLAS
handle.

With ``--against DIR`` (a checkout of another commit, such as the parent
unpacked by ``git archive``) it builds that checkout's kernels into its own
``build/`` and times its four sampler kernels, K3 (a stage-2 step's problems
through each tree's ``assign_many``) and P2-P4 against this tree's in turns
(theirs, ours, ours, theirs) at the shapes of phases 3, 3b, 5f and 8, fp32,
device time, checking that the two agree (K2 without ``lvl``, K3 and P2-P4
bit for bit; the backward kernels within ``KERNEL_RTOL`` of scale, whose
order of addition may differ); K1-bwd and K2-bwd through each of the other
tree's routes (``launch(route, ...)`` where its wrappers declare
``routes``), also at a stage-2 step's own largest calls; then phases
4-7's paths in turns, and each tree's synchronizing calls in one training
step, by call site. With ``--profile-routes`` (and ``--against``, the other
tree first) it profiles one call of each backward design, launch by launch,
at phase 3b's shapes and a step's largest calls, this tree's binned plans at
each of ``PROFILE_COUNTS_PER_ITEM``, and stops.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

# torch's deterministic flag, which [kernels-bwd], [train], [train-cli] and
# [serve] turn on, needs this before the first cuBLAS handle exists
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"  # every phase runs here; there is no CPU fallback
WARMUP_FRAMES, TIMED_FRAMES = 2, 8
# kernel vs plain version on the same inputs: both read the same values into
# fp32 and sum in fp32 in another order (<= 4 taps x 6 cameras, or x 2 slots
# x 2 levels): |diff| <= KERNEL_RTOL * max|plain|.
KERNEL_RTOL = 1e-5
# card frame vs CPU frame (plain path): convolutions, GEMMs and the sampler
# sum in other orders on the two devices through ResNet-50 and six decoder
# layers (each layer's anchors move its next keypoints, so differences grow
# from layer to layer): |diff| <= E2E_RTOL * max|cpu| + E2E_ATOL.
E2E_RTOL, E2E_ATOL = 1e-3, 1e-4
# bf16 frame vs fp32 frame on the card, plan.final_waypoints, frame 0 (cold
# banks) and frame 1 (on frame 0's banks): twice the relative bf16/fp32
# spread of the JAX package's own frames on the same frame, as
# tests/test_torch_bf16.py allows it at tiny() (which checks these bounds
# against JAX's spread: 3.331e-4 of scale on the first frame, 1.249e-3 on
# the second): |diff| <= BF16_FRAME_RTOL[i] * max|fp32|.
BF16_FRAME_RTOL = (6.7e-4, 2.5e-3)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Median per-call device time over ``iters`` calls, by CUDA events."""
    import torch

    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc={smi.returncode})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 off")
    say(card)
    return card


def phase_build():
    from hipad_torch.ops import kernels

    t0 = time.perf_counter()
    lib = kernels.library()
    say(f"[build] {lib.path.relative_to(ROOT)} from hipad_torch/csrc/*.cu for sm_90a: "
        f"nvcc {lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s")
    kernel = "?"
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "registers" in line or "spill" in line:
            say(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}")


def _kernel_name(line: str) -> str:
    """``name<type,NCH>`` of the kernel a ptxas line names by its mangled
    symbol ``_ZN<len><namespace><len><name>I<args>E...``: the nested name
    ending in ``_kernel`` and its template arguments (f: fp32,
    13__nv_bfloat16: bf16, Li<n>E: an int)."""
    sym = line.split("'")[1] if "'" in line else line
    pos = 3 if sym.startswith("_ZN") else len(sym)
    while pos < len(sym) and sym[pos].isdigit():
        digits = re.match(r"\d+", sym[pos:]).group()
        start = pos + len(digits)
        ident, pos = sym[start:start + int(digits)], start + int(digits)
        if ident.endswith("_kernel"):
            args = re.match(r"(?:I(f|13__nv_bfloat16)?(?:Li(\d+)E)?)?", sym[pos:])
            parts = [{"f": "fp32", "13__nv_bfloat16": "bf16"}.get(args.group(1)), args.group(2)]
            parts = [p for p in parts if p]
            return f"{ident}<{','.join(parts)}>" if parts else ident
    return sym


def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())


# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s
# and fp32 FLOP/s outside the tensor cores. The sampler kernels do fp32
# arithmetic on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: (ms, "bytes" | "operations")."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _timed(fns, iters=20):
    """CUDA-event medians of fns in the order given -> list of ms."""
    return [cuda_time_ms(f, iters) for f in fns]


def _times(fns):
    """(device ms, per-call ms) of each fn: ``_device_ms`` and ``_timed``."""
    return _device_ms(fns), _timed(fns)


QUEUED = ("device time: 20 calls (fewer where they fill the launch queue) queued behind a "
          "sleep kernel that outlasts their queueing (checked), CUDA events, median of 5")
TIMES = f"{QUEUED}, in turns plain/kernel/kernel/plain"
# the longest sleep _device_ms puts before its calls; a function whose one call
# takes longer than this to queue syncs with the host and cannot be timed so
MAX_SLEEP_MS = 4000.0


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    torch.cuda._sleep(1_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def _device_ms(fns, iters=20, reps=5):
    """Device time per call of each fn, in the order given: ``iters`` calls
    queued behind a ``torch.cuda._sleep`` kernel, so that the card runs them
    back to back, timed by CUDA events around them; the median of ``reps``
    -> list of ms. Unlike events around one call, it leaves out the host's
    time to launch, which dominates a copy of a few microseconds.

    The sleep lasts twice the host's time to queue the ``iters`` calls, taken
    just before, plus 1 ms. A repeat in which the event after the sleep has
    already passed when the last call is queued (the card waited for the
    host) is dropped, and the function is timed again with half as many
    calls: the card's queue of pending launches (about a thousand) blocks
    the host once a function's calls fill it. With one call left, the sleep
    is doubled instead."""
    import torch

    cycles_per_ms = _sleep_cycles_per_ms()
    out = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        sleep_ms = 2 * (time.perf_counter() - t) * 1e3 + 1.0
        n, times = iters, []
        while len(times) < reps:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            start.record()
            for _ in range(n):
                fn()
            end.record()
            host_bound = start.query()
            end.synchronize()
            if host_bound:
                times = []
                if n > 1:
                    n //= 2
                    continue
                sleep_ms *= 2
                if sleep_ms > MAX_SLEEP_MS:
                    fail(f"one call outlasts a {MAX_SLEEP_MS:g} ms sleep kernel while being "
                         "queued: the function syncs with the host")
                continue
            times.append(start.elapsed_time(end) / n)
        out.append(statistics.median(times))
    return out


class _Rec:
    """Per-kernel numbers for the JSON line, per launch: times and bounds
    added over the calls timed, then ``per_launch`` divides them by their
    count (K1-bwd: one launch a coarse level, two timed)."""

    def __init__(self):
        self.err = self.ms = self.plain_ms = self.bound_ms = self.library_ms = 0.0
        self.per_call_ms = 0.0  # CUDA events around one call, Python launch path included
        self.bound_by = ""

    def add_times(self, dev_ms, call_ms):
        """Add the times of [plain, kernel, kernel, plain, library] (device
        times, then per-call times) -> (kernel, plain, library) device ms."""
        t = (min(dev_ms[1], dev_ms[2]), min(dev_ms[0], dev_ms[3]), dev_ms[4])
        self.ms += t[0]
        self.plain_ms += t[1]
        self.library_ms += t[2]
        self.per_call_ms += min(call_ms[1], call_ms[2])
        return t

    def add_bound(self, ms_by):
        self.bound_ms += ms_by[0]
        self.bound_by = ms_by[1]

    def per_launch(self, n: int):
        for f in ("ms", "plain_ms", "library_ms", "per_call_ms", "bound_ms"):
            setattr(self, f, getattr(self, f) / n)


def _det_samples(cfg, point_frac=1.0):
    """The det task's flat sample count M0: anchors x keypoints kept."""
    n_pts = len(cfg.det_kps.fix_scale) + cfg.det_kps.num_learnable
    return cfg.num_det_anchor * math.ceil(point_frac * n_pts)


def _k1_inputs(cfg, g, dev, dtype, bs=1, m0=None, with_acc=True):
    """K1's inputs in the sampler's layout at the det task's M0 (or ``m0``):
    acc ``[bs, M0, C]`` fp32 (or None), the coarse maps, points ``[bs, M0,
    cams, 2]`` fp32 and weights ``[bs, M0, cams, L, G]``, maps and weights in
    ``dtype``, and the coarse level indices. x and y are uniform in (-0.4,
    1.4): a point lies inside each camera with probability 0.31, inside 1.9
    of 6 on average, as the rig's projected keypoints lie inside one or two;
    every 50th sample sits on level 2's pixel centres in every camera
    (integer pixel coordinates: the hat weights' kinks)."""
    import torch

    cams, C, G, L = cfg.num_cams, cfg.embed_dims, cfg.num_groups, cfg.num_levels
    H, W = cfg.input_size
    levels = [l for l in cfg.sampler_matmul_levels if l < L]
    m0 = m0 or _det_samples(cfg)
    maps = [torch.randn(bs, cams, H // cfg.strides[l], W // cfg.strides[l], C, generator=g,
                        device=dev).to(dtype) for l in levels]
    pts = torch.rand(bs, m0, cams, 2, generator=g, device=dev) * 1.8 - 0.4
    h2, w2 = maps[0].shape[2:4]
    n = pts[:, ::50].shape[1]
    pts[:, ::50, :, 0] = (torch.randint(0, w2, (bs, n, cams), generator=g, device=dev) + 0.5) / w2
    pts[:, ::50, :, 1] = (torch.randint(0, h2, (bs, n, cams), generator=g, device=dev) + 0.5) / h2
    weights = torch.rand(bs, m0, cams, L, G, generator=g, device=dev).to(dtype)
    acc = torch.randn(bs, m0, C, generator=g, device=dev) if with_acc else None
    return acc, maps, pts, weights, levels


def _k1_bwd_inputs(cfg, g, dev, lvl, dtype, bs=1):
    """K1-bwd's inputs for coarse level ``lvl``: the camera-major fm
    ``[bs*cams, H, W, C]``, pixel coordinates px, py ``[bs*cams, M0]`` past
    every border (every 50th on an integer: the kinks) and group weights
    ``wg [bs*cams, M0, G]``, 40% of the (sample, camera) pairs non-zero."""
    cams, C, G = cfg.num_cams, cfg.embed_dims, cfg.num_groups
    H, W = cfg.input_size
    h, w = H // cfg.strides[lvl], W // cfg.strides[lvl]
    M0 = _det_samples(cfg)
    import torch

    fm = torch.randn(bs * cams, h, w, C, generator=g, device=dev).to(dtype)
    px = torch.rand(bs * cams, M0, generator=g, device=dev) * (w + 2) - 1.5
    py = torch.rand(bs * cams, M0, generator=g, device=dev) * (h + 2) - 1.5
    px[:, ::50] = px[:, ::50].round()
    py[:, ::50] = py[:, ::50].round()
    wg = torch.rand(bs * cams, M0, G, generator=g, device=dev)
    wg = wg * (torch.rand(bs * cams, M0, 1, generator=g, device=dev) < 0.4)
    return fm, px, py, wg, bs, cams


def _k2_inputs(cfg, g, dev, dtype, bs=1):
    import torch

    cams, C, G = cfg.num_cams, cfg.embed_dims, cfg.num_groups
    H, W = cfg.input_size
    fine = [l for l in range(cfg.num_levels) if l not in cfg.sampler_matmul_levels]
    cam_k = cfg.sampler_cam_k
    M = _det_samples(cfg) * cam_k
    maps = [torch.randn(bs, cams, H // cfg.strides[l], W // cfg.strides[l], C, generator=g,
                        device=dev).to(dtype) for l in fine]
    cam = torch.randint(0, cams, (bs, M), generator=g, device=dev, dtype=torch.int32)
    x = torch.rand(bs, M, generator=g, device=dev) * 1.2 - 0.1
    y = torch.rand(bs, M, generator=g, device=dev) * 1.2 - 0.1
    inside = ((x > 0) & (x < 1) & (y > 0) & (y < 1)).float()
    w = torch.rand(bs, M, len(fine), G, generator=g, device=dev)
    w = w * (torch.rand(bs, M, 1, 1, generator=g, device=dev) < 0.7) * inside[..., None, None]
    return maps, cam, x, y, w, cam_k


def _tap_ok(ty, tx, bwd):
    """Whether a tap at hat arguments ``|ty|, |tx|`` is read: the forward
    reads taps whose hat weight is non-zero; the backward also those whose
    weight is zero but whose hat derivative is not (a kink, |t| == 1)."""
    if not bwd:
        return (ty < 1) & (tx < 1)
    return (ty <= 1) & (tx <= 1) & ~((ty == 1) & (tx == 1))


def _k1_reads(px, py, wg, h, w, bwd):
    """(taps read, distinct map rows read) by K1 (or K1-bwd) on one level.
    The forward skips (sample, camera) pairs whose group weights are all
    zero; the backward reads every pair in range, because d wg needs the
    sampled row whatever the weight."""
    import torch

    B, M = px.shape
    bc = torch.arange(B, device=px.device)[:, None].expand(B, M)
    if bwd:
        ok0 = (px >= -1) & (px <= w) & (py >= -1) & (py <= h)
        offs = (-1, 0, 1)
    else:
        ok0 = (px > -1) & (px < w) & (py > -1) & (py < h) & (wg != 0).any(-1)
        offs = (0, 1)
    x0, y0 = px.clamp(-2, w + 1).floor(), py.clamp(-2, h + 1).floor()
    cells = []
    for dy in offs:
        for dx in offs:
            yy, xx = y0 + dy, x0 + dx
            ok = (ok0 & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                  & _tap_ok((py - yy).abs(), (px - xx).abs(), bwd))
            cells.append(((bc * h + yy.long()) * w + xx.long())[ok])
    cells = torch.cat(cells)
    return cells.numel(), int(torch.unique(cells).numel())


def _k2_reads(maps, cam, x, y, w, bwd, lvl=None):
    """(taps read, map bytes read) by K2 (or K2-bwd) over its fine levels,
    or by their level-k variants (``lvl``) over each sample's kept levels.
    The forward skips (slot, level) pairs whose group weights are all zero;
    the backward reads every slot with a valid camera (d w needs the row)."""
    import torch

    bs, M = x.shape
    cams = maps[0].shape[1]
    bcam = (torch.arange(bs, device=x.device)[:, None] * cams + cam).long()
    valid = (cam >= 0) & (cam < cams)
    taps, nbytes = 0, 0
    for l, m in enumerate(maps):
        H, W, C = m.shape[2:]
        if lvl is None:
            keep, live = valid, (w[:, :, l] != 0).any(-1)
        else:  # the slots that keep level l
            kept = lvl == l
            keep, live = valid & kept.any(-1), (kept & (w != 0).any(-1)).any(-1)
        ok0 = keep if bwd else keep & live
        p, q = x * W - 0.5, y * H - 0.5
        sx, sy = p.floor().clamp(0, W - 2), q.floor().clamp(0, H - 2)
        cells = []
        for i in (0, 1):
            for j in (0, 1):
                ok = ok0 & _tap_ok((q - (sy + i)).abs(), (p - (sx + j)).abs(), bwd)
                cells.append(((bcam * H + (sy + i).long()) * W + (sx + j).long())[ok])
        cells = torch.cat(cells)
        taps += cells.numel()
        nbytes += int(torch.unique(cells).numel()) * C * m.element_size()
    return taps, nbytes


def _k1_reads_coarse(acc, maps, pts, weights, levels):
    """(taps read, bytes K1 must move) for these inputs: the distinct map
    rows its live taps read over every coarse level, the acc row read and
    the out row written, the points and the coarse levels' weights."""
    from hipad_torch.ops import sampling

    xf, yf, _, wf = sampling._coarse_inputs(pts, weights)
    taps, nbytes = 0, 0
    for lvl, fm in zip(levels, maps):
        h, w, C = fm.shape[2:]
        t, rows = _k1_reads(xf * w - 0.5, yf * h - 0.5, wf[:, :, lvl], h, w, bwd=False)
        taps += t
        nbytes += rows * C * fm.element_size()
    bs, M0, cams, _ = pts.shape
    G = weights.shape[-1]
    rows_io = (2 if acc is not None else 1) * bs * M0 * maps[0].shape[-1] * 4
    return taps, nbytes + rows_io + _nbytes(pts) + bs * M0 * cams * len(levels) * G * \
        weights.element_size()


def _grid_sample_args(maps, pts):
    """F.grid_sample's inputs for each map of ``[bs, cams, H, W, C]``: the
    NCHW maps of each camera and the camera-major sample grid in [-1, 1]."""
    bs, M0, cams, _ = pts.shape
    grid = pts.permute(0, 2, 1, 3).reshape(bs * cams, 1, M0, 2) * 2 - 1
    return [(m.reshape(bs * cams, *m.shape[2:]).permute(0, 3, 1, 2), grid) for m in maps]


def phase_kernels(cfg, card: str):
    """K1 (every coarse level in one launch, all 6 cameras, added to an acc)
    and K2 (levels 0-1, cam_k slots) against their plain versions at the det
    task's sample count, fp32 and bf16, bs 1 and 2, K1 also without acc and
    at the serving config's keypoint top-k; timed at bs=1 fp32."""
    import torch
    import torch.nn.functional as F

    from hipad_torch.configs.model import stage2_serving_det
    from hipad_torch.ops import kernels, sampling

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED)
    k1, k2 = _Rec(), _Rec()
    f32, bf16 = torch.float32, torch.bfloat16
    m0_serve = _det_samples(cfg, stage2_serving_det().sampler_point_frac)

    # ---- K1 -------------------------------------------------------------
    for dtype, bs, m0, with_acc in ((f32, 1, None, True), (f32, 1, None, False),
                                    (bf16, 1, None, True), (bf16, 1, None, False),
                                    (f32, 2, None, True), (bf16, 2, None, True),
                                    (f32, 1, m0_serve, True)):
        acc, maps, pts, wts, levels = _k1_inputs(cfg, g, dev, dtype, bs, m0, with_acc)
        M0, C = pts.shape[1], maps[0].shape[-1]
        got = kernels.coarse_sample(acc, maps, pts, wts, levels)
        ref = sampling.coarse_sample_plain(acc, maps, pts, wts, levels)
        torch.cuda.synchronize()
        err, scale = _max_err(got, ref)
        ok = err <= KERNEL_RTOL * scale
        say(f"[kernels] K1 coarse_sample levels {levels} "
            f"{[tuple(m.shape[2:4]) for m in maps]} {str(dtype)[6:]} bs={bs} M0={M0} C={C} "
            f"acc={'yes' if with_acc else 'None'}: max_abs_err {err:.3e} (tol {KERNEL_RTOL:g} x "
            f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K1 disagrees with its plain version ({dtype}, bs={bs}, M0={M0}, "
                 f"acc={with_acc})")
        k1.err = max(k1.err, err)
        if dtype == f32 and bs == 1 and m0 is None and with_acc:
            lib = _grid_sample_args(maps, pts)
            t = k1.add_times(*_times([
                lambda: sampling.coarse_sample_plain(acc, maps, pts, wts, levels),
                lambda: kernels.coarse_sample(acc, maps, pts, wts, levels),
                lambda: kernels.coarse_sample(acc, maps, pts, wts, levels),
                lambda: sampling.coarse_sample_plain(acc, maps, pts, wts, levels),
                lambda: [F.grid_sample(m, gr, align_corners=False) for m, gr in lib]]))
            taps, nbytes = _k1_reads_coarse(acc, maps, pts, wts, levels)
            b = bound(nbytes, taps * C * 2)
            k1.add_bound(b)
            say(f"[kernels] K1 fp32 on {card}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
                f"F.grid_sample (per camera and level, no weights or sums: not the same "
                f"function) {t[2]:.4f} ms ({TIMES}); per call {k1.per_call_ms:.4f} ms; bound "
                f"{b[0]:.4f} ms ({b[1]}: {taps} taps, {nbytes / 1e6:.2f} MB: map rows read, "
                f"acc and out rows, points, coarse weights)")

    # ---- K2 -------------------------------------------------------------
    for dtype, bs in ((f32, 1), (bf16, 1), (f32, 2)):
        maps, cam, x, y, w, cam_k = _k2_inputs(cfg, g, dev, dtype, bs)
        M = x.shape[1]
        C = maps[0].shape[-1]
        got = kernels.patch_sample(maps, cam, x, y, w, cam_k)
        ref = sampling.patch_sample_plain(maps, cam, x, y, w, cam_k)
        torch.cuda.synchronize()
        err, scale = _max_err(got, ref)
        ok = err <= KERNEL_RTOL * scale
        say(f"[kernels] K2 patch_sample levels {[tuple(m.shape[2:4]) for m in maps]} "
            f"{str(dtype)[6:]} bs={bs} M={M} cam_k={cam_k} C={C}: max_abs_err {err:.3e} "
            f"(tol {KERNEL_RTOL:g} x {scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K2 disagrees with its plain version, {dtype}, bs={bs}")
        k2.err = max(k2.err, err)
        if dtype == f32 and bs == 1:
            cams = maps[0].shape[1]
            lib = [(m.reshape(bs * cams, *m.shape[2:]).permute(0, 3, 1, 2),
                    torch.stack([x, y], -1).reshape(bs * cams, 1, -1, 2) * 2 - 1)
                   for m in maps] if M % cams == 0 else []
            k2.add_times(*_times([
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k),
                lambda: kernels.patch_sample(maps, cam, x, y, w, cam_k),
                lambda: kernels.patch_sample(maps, cam, x, y, w, cam_k),
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k),
                lambda: [F.grid_sample(m, gr, align_corners=False) for m, gr in lib]]))
            taps, map_bytes = _k2_reads(maps, cam, x, y, w, bwd=False)
            k2.add_bound(bound(map_bytes + _nbytes(cam, x, y, w, got), taps * C * 2))
            say(f"[kernels] K2 fp32 on {card}: kernel {k2.ms:.4f} ms, plain "
                f"{k2.plain_ms:.4f} ms, F.grid_sample (same sample count spread over the "
                f"cameras, no weights: not the same function) {k2.library_ms:.4f} ms "
                f"({TIMES}); per call {k2.per_call_ms:.4f} ms; bound {k2.bound_ms:.4f} ms "
                f"({k2.bound_by}: {taps} taps, {map_bytes / 1e6:.2f} of "
                f"{_nbytes(*maps) / 1e6:.2f} MB of maps read)")
    return {"coarse_sample": k1, "patch_sample": k2}


# Backward kernel vs autograd of the plain version, fp32 gradients: both sum
# fp32 products in other orders (over C channels, <= 9 taps and 6 cameras or
# 2 slots x 2 levels, and over every sample that touches a map cell, which
# the kernels add in their bins' order): |diff| <= GRAD_RTOL * max|plain|
# per gradient, the forward kernels' tolerance (seen on an H100: <= 6.8e-7
# of scale). With bf16 maps the map gradient is rounded to bf16 on both
# sides from fp32 values that differ in their last bits, so one bf16 step:
# GRAD_BF16_RTOL.
GRAD_RTOL = KERNEL_RTOL
GRAD_BF16_RTOL = 8e-3


def _check_grads(what, got, ref, bf16_first, tag="[kernels-bwd]"):
    worst = 0.0
    for i, (name, a, b) in enumerate(zip(("fm", "x", "y", "w"), got, ref)):
        if isinstance(a, (list, tuple)):
            errs = [_max_err(ai, bi) for ai, bi in zip(a, b)]
            err, scale = max(e for e, _ in errs), max(s for _, s in errs)
        else:
            err, scale = _max_err(a, b)
        rtol = GRAD_BF16_RTOL if (i == 0 and bf16_first) else GRAD_RTOL
        ok = err <= rtol * scale
        say(f"{tag} {what} d{name}: max_abs_err {err:.3e} (tol {rtol:g} x "
            f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what}: d{name} disagrees with autograd of the plain version")
        worst = max(worst, err)
    return worst


@contextlib.contextmanager
def flag(on: bool):
    """torch's deterministic flag (``torch.use_deterministic_algorithms``) set
    to ``on`` inside, its earlier state restored after."""
    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _bits_equal(a, b) -> bool:
    """Two outputs (tensors, or tuples of tensors and lists of them) equal
    bit for bit: same shapes, dtypes and values, NaN nowhere."""
    import torch

    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def _bwd_repeats(tag, what, kernel, args, ref, bf16_first):
    """A backward wrapper on ``args``: its gradients against autograd of the
    plain version (``ref``) at ``_check_grads``' tolerances, and a second
    call on the same inputs, held bit for bit; then two calls under torch's
    deterministic flag, bit for bit equal to each other and to the calls
    above (under the flag ``torch.empty`` fills its memory with NaN, so an
    element the kernel leaves unwritten shows) -> its largest error."""
    import torch

    a = kernel(*args)
    b = kernel(*args)
    torch.cuda.synchronize()
    worst = _check_grads(what, a, ref, bf16_first, tag)
    same = _bits_equal(a, b)
    say(f"{tag} {what}: two calls on the same inputs {'equal bit for bit' if same else 'differ'}")
    if not same:
        fail(f"{what}: two calls on the same inputs differ")
    with flag(True):
        c, d = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    ok = _bits_equal(c, d) and _bits_equal(c, a)
    say(f"{tag} {what} under torch.use_deterministic_algorithms(True): two calls equal bit for "
        f"bit and equal to the calls above {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: under the deterministic flag the calls do not repeat the bits")
    return worst


def _plan_text(plan) -> str:
    """A binned plan in words: bins, segment width per map size, chunks,
    cells a warp and warps a run of cells."""
    return (f"{plan.nbins} bins of {'/'.join(str(t.sw) for t in plan.levels)} column(s), "
            f"{plan.chunks} chunks, {plan.ow} cell(s) a warp, split {plan.split}")


def _clone_args(args):
    import torch

    return tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                 else [t.detach().clone() for t in a] if isinstance(a, list) else a
                 for a in args)


def step_bwd_calls():
    """The sampler's backward calls of one stage-2 fp32 training step at bs=1
    (random weights from SEED, the synthetic batch, the config's dropout and
    GridMask), recorded as the step makes them: the inputs of the largest
    K1-bwd call of each coarse map size (by samples) and of the largest
    K2-bwd call (by slots) -> [(what, wrapper name, args)], args cloned."""
    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.ops import kernels
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2()
    kept = {}
    names = ("interp_sample_camsum_bwd", "patch_sample_bwd")
    wrappers = {n: getattr(kernels, n) for n in names}

    def recording(name):
        def call(*args):
            if name == "interp_sample_camsum_bwd":
                key, size = f"K1-bwd {args[0].shape[1]}x{args[0].shape[2]}", args[1].numel()
            else:
                key, size = "K2-bwd", args[2].numel()
            if key not in kept or size > kept[key][0]:
                kept[key] = (size, name, _clone_args(args))
            return wrappers[name](*args)
        return call

    model = init_random(HiPAD(cfg, device=dev), SEED)
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic.make_batch(cfg, 1, seed=SEED).items()}
    try:
        for n in names:
            setattr(kernels, n, recording(n))
        step(None, batch, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
    finally:
        for n, w in wrappers.items():
            setattr(kernels, n, w)
    del model, step
    torch.cuda.empty_cache()
    return [(f"a stage-2 step's largest {key} call", name, args)
            for key, (_, name, args) in sorted(kept.items())]


def _k1_bwd_ref(args):
    """Autograd of the plain K1-bwd (``interp_matmul_camsum``) on ``args``."""
    import torch

    from hipad_torch.ops import sampling

    fm, px, py, wg, gout, bs, cams = args
    leaves = [t.detach().clone().requires_grad_() for t in (fm, px, py, wg)]
    out = sampling.interp_matmul_camsum(*leaves, bs, cams)
    return torch.autograd.grad(out, leaves, gout)


def _k2_bwd_ref(args):
    """Autograd of the plain K2-bwd (``patch_sample_plain``) on ``args``,
    the map gradients as one list."""
    import torch

    from hipad_torch.ops import sampling

    maps, cam, x, y, w, gout, cam_k = args[:7]
    lvl = args[7] if len(args) > 7 else None
    lm = [m.detach().clone().requires_grad_() for m in maps]
    lx, ly, lw = (t.detach().clone().requires_grad_() for t in (x, y, w))
    out = sampling.patch_sample_plain(lm, cam, lx, ly, lw, cam_k, lvl)
    ref = torch.autograd.grad(out, lm + [lx, ly, lw], gout)
    return (ref[:len(lm)],) + tuple(ref[len(lm):])


def _step_shapes(card: str):
    """``[kernels-bwd]``'s step shapes: each call of ``step_bwd_calls``,
    fp32 as recorded and with bf16 maps, against autograd of the plain
    version, twice bit for bit and under the flag (``_bwd_repeats``), its
    plan printed; the fp32 call's device time -> the largest error of each
    wrapper."""
    import torch

    from hipad_torch.ops import kernels

    worst = {}
    for what, name, args in step_bwd_calls():
        kernel = getattr(kernels, name)
        if name == "interp_sample_camsum_bwd":
            fm, px = args[0], args[1]
            plan = kernels.k1_bwd_plan(fm.shape[0], fm.shape[1], fm.shape[2], px.shape[1])
            shape = f"{fm.shape[0]} maps, {px.shape[1]} samples"
        else:
            maps, x = args[0], args[2]
            plan = kernels.k2_bwd_plan(x.shape[0], maps[0].shape[1], [m.shape[2:4] for m in maps],
                                       x.shape[1], args[4].shape[2])
            shape = f"{x.shape[0] * maps[0].shape[1]} maps, {x.shape[1]} slots"
        for dtype in (torch.float32, torch.bfloat16):
            a = args
            if dtype == torch.bfloat16:
                a = ((args[0].to(dtype),) + args[1:] if name == "interp_sample_camsum_bwd" else
                     ([m.to(dtype) for m in args[0]],) + args[1:])
            ref = _k1_bwd_ref(a) if name == "interp_sample_camsum_bwd" else _k2_bwd_ref(a)
            tag = f"{what} ({shape}; {_plan_text(plan)}) {str(dtype)[6:]}"
            worst[name] = max(worst.get(name, 0.0),
                              _bwd_repeats("[kernels-bwd]", tag, kernel, a, ref,
                                           dtype == torch.bfloat16))
            del ref
        dev_ms, call = _times([lambda: kernel(*args)])
        say(f"[kernels-bwd] {what} ({shape}; {_plan_text(plan)}) fp32 on {card}: kernel "
            f"{dev_ms[0]:.4f} ms ({QUEUED}); per call {call[0]:.4f} ms")
    return worst


def phase_kernels_bwd(cfg, card: str):
    """K1-bwd and K2-bwd at phase 3's shapes against torch.autograd.grad of
    the plain versions, fp32 and bf16 maps, bs=1 and 2; K1-bwd also on the
    44x80 and 88x160 maps (levels 2 and 1) of ``stage2_r101_2x()``, fp32;
    both at a stage-2 step's own largest calls, recorded from a step
    (``_step_shapes``). Timed at bs=1 fp32 against the plain backward (the
    graph built once, retained), and on the 88x160 map; K1-bwd's record per
    launch (the mean of its two coarse levels')."""
    import torch
    import torch.nn.functional as F

    from hipad_torch.configs.model import stage2_r101_2x
    from hipad_torch.ops import kernels, sampling

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    k1, k2 = _Rec(), _Rec()
    k1_timed = 0

    f32, bf16 = torch.float32, torch.bfloat16
    r101 = stage2_r101_2x()
    for c, dtype, bs, levels in ((cfg, f32, 1, None), (cfg, bf16, 1, None), (cfg, f32, 2, None),
                                 (cfg, bf16, 2, None), (r101, f32, 1, (2, 1))):
        timed = c is cfg and dtype == f32 and bs == 1
        for lvl in levels or [l for l in c.sampler_matmul_levels if l < c.num_levels]:
            fm, px, py, wg, bs, cams = _k1_bwd_inputs(c, g, dev, lvl, dtype, bs)
            B, h, w, C = fm.shape
            plan = kernels.k1_bwd_plan(B, h, w, px.shape[1])
            gout = torch.randn(bs, px.shape[1], C, generator=g, device=dev)
            leaves = [t.detach().clone().requires_grad_() for t in (fm, px, py, wg)]
            out = sampling.interp_matmul_camsum(*leaves, bs, cams)
            ref = torch.autograd.grad(out, leaves, gout, retain_graph=True)
            args = (fm, px, py, wg, gout, bs, cams)
            got = kernels.interp_sample_camsum_bwd(*args)
            torch.cuda.synchronize()
            if got[0].dtype != dtype:
                fail(f"K1-bwd returned d fm in {got[0].dtype} for a {dtype} map")
            what = f"K1-bwd level {lvl} ({h}x{w}) {str(dtype)[6:]} bs={bs} ({_plan_text(plan)})"
            k1.err = max(k1.err, _bwd_repeats("[kernels-bwd]", what,
                                              kernels.interp_sample_camsum_bwd, args, ref,
                                              dtype == bf16))
            if timed or (c is r101 and lvl == 1):
                grid = torch.stack([(px + 0.5) / w * 2 - 1, (py + 0.5) / h * 2 - 1], -1)[:, None]
                lib_in = [fm.permute(0, 3, 1, 2).detach().clone().requires_grad_(),
                          grid.detach().clone().requires_grad_()]
                lib_out = F.grid_sample(*lib_in, align_corners=False)
                lib_g = torch.randn_like(lib_out)
                dev_ms, call = _times([
                    lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True),
                    lambda: kernels.interp_sample_camsum_bwd(fm, px, py, wg, gout, bs, cams),
                    lambda: kernels.interp_sample_camsum_bwd(fm, px, py, wg, gout, bs, cams),
                    lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True),
                    lambda: torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True)])
                rec = k1 if timed else _Rec()  # the 88x160 map is not on the main path
                k1_timed += timed
                t = rec.add_times(dev_ms, call)
                # reads: the rows it samples and every small input; writes:
                # all of d fm and the coordinate and weight gradients
                taps, rows = _k1_reads(px, py, wg, h, w, bwd=True)
                b = bound(rows * C * fm.element_size() + _nbytes(px, py, wg, gout)
                          + _nbytes(*got), taps * C * 4)
                rec.add_bound(b)
                say(f"[kernels-bwd] K1-bwd level {lvl} ({h}x{w}) fp32 on {card}: kernel "
                    f"{t[0]:.4f} ms, "
                    f"plain backward {t[1]:.4f} ms, F.grid_sample backward (not the same "
                    f"function) {t[2]:.4f} ms ({TIMES}); per call {min(call[1], call[2]):.4f} "
                    f"ms; bound {b[0]:.4f} ms ({b[1]}: {taps} taps, {rows} of {B * h * w} map "
                    f"rows read)")
            del leaves, out, ref, got

    for dtype, bs in ((f32, 1), (bf16, 1), (f32, 2), (bf16, 2)):
        timed = dtype == f32 and bs == 1
        maps, cam, x, y, w, cam_k = _k2_inputs(cfg, g, dev, dtype, bs)
        # every 50th location on a pixel corner of level 0: the kinks
        W0 = maps[0].shape[3]
        x[:, ::50] = ((x[:, ::50] * W0 - 0.5).round() + 0.5) / W0
        bs, M = x.shape
        C = maps[0].shape[-1]
        gout = torch.randn(bs, M // cam_k, C, generator=g, device=dev)
        lm = [m.detach().clone().requires_grad_() for m in maps]
        lx, ly, lw = (t.detach().clone().requires_grad_() for t in (x, y, w))
        out = sampling.patch_sample_plain(lm, cam, lx, ly, lw, cam_k)
        ref = torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True)
        ref = (ref[:len(lm)],) + tuple(ref[len(lm):])
        args = (maps, cam, x, y, w, gout, cam_k)
        dmaps, dx, dy, dw = kernels.patch_sample_bwd(*args)
        torch.cuda.synchronize()
        plan = kernels.k2_bwd_plan(bs, maps[0].shape[1], [m.shape[2:4] for m in maps], M,
                                   len(maps))
        what = f"K2-bwd {str(dtype)[6:]} bs={bs} ({_plan_text(plan)})"
        k2.err = max(k2.err, _bwd_repeats("[kernels-bwd]", what, kernels.patch_sample_bwd, args,
                                          ref, dtype == bf16))
        if timed:
            cams = maps[0].shape[1]
            lib_in = [[m.reshape(bs * cams, *m.shape[2:]).permute(0, 3, 1, 2).detach().clone()
                       .requires_grad_(),
                       (torch.stack([x, y], -1).reshape(bs * cams, 1, -1, 2) * 2 - 1)
                       .requires_grad_()] for m in maps]
            lib_out = [F.grid_sample(*a, align_corners=False) for a in lib_in]
            lib_g = [torch.randn_like(o) for o in lib_out]
            k2.add_times(*_times([
                lambda: torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True),
                lambda: kernels.patch_sample_bwd(maps, cam, x, y, w, gout, cam_k),
                lambda: kernels.patch_sample_bwd(maps, cam, x, y, w, gout, cam_k),
                lambda: torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True),
                lambda: [torch.autograd.grad(o, a, go, retain_graph=True)
                         for o, a, go in zip(lib_out, lib_in, lib_g)]]))
            taps, map_bytes = _k2_reads(maps, cam, x, y, w, bwd=True)
            k2.add_bound(bound(map_bytes + _nbytes(cam, x, y, w, gout, *dmaps, dx, dy, dw),
                               taps * C * 4))
            say(f"[kernels-bwd] K2-bwd fp32 on {card}: kernel {k2.ms:.4f} ms, plain backward "
                f"{k2.plain_ms:.4f} ms, F.grid_sample backward (not the same function) "
                f"{k2.library_ms:.4f} ms ({TIMES}); per call {k2.per_call_ms:.4f} ms; bound "
                f"{k2.bound_ms:.4f} ms ({k2.bound_by}: {taps} taps, {map_bytes / 1e6:.2f} of "
                f"{_nbytes(*maps) / 1e6:.2f} MB of maps read)")
    step = _step_shapes(card)
    k1.err = max(k1.err, step["interp_sample_camsum_bwd"])
    k2.err = max(k2.err, step["patch_sample_bwd"])
    k1.per_launch(k1_timed)
    say(f"[kernels-bwd] K1-bwd per launch (one a coarse level; the mean of the two levels') on "
        f"{card}: kernel {k1.ms:.4f} ms, per call {k1.per_call_ms:.4f} ms, bound "
        f"{k1.bound_ms:.4f} ms")
    return {"interp_sample_camsum_bwd": k1, "patch_sample_bwd": k2}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def phase_slice(cfg, card: str):
    """The main path at stage 2, bs=1, chained frames; then frame 1 on the CPU."""
    import dataclasses

    import torch

    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.ops import kernels
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = init_random(HiPAD(cfg, device=dev), SEED)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)
    say(f"[slice] stage2 built with seeded weights on the card in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters")

    n_deform, per_call = _launch_plan(cfg)
    per_call = {k: v for k, v in per_call.items() if not k.endswith("_bwd")}  # no gradient
    n_frames = WARMUP_FRAMES + TIMED_FRAMES

    def frame_inputs(i):
        m = dict(metas)
        m["timestamp"] = metas["timestamp"] + 0.5 * i
        return images + 1e-3 * i, m

    def run_frames(dtype):
        """Chained frames (autocast to ``dtype`` unless fp32) -> frame-0 leaves,
        launches per kernel over the frames."""
        for k in kernels.KERNELS:
            k.launches = 0
        banks, times, kept = None, [], []
        with torch.no_grad(), torch.autocast("cuda", dtype=dtype,
                                             enabled=dtype != torch.float32):
            for i in range(n_frames):
                img, m = frame_inputs(i)
                torch.cuda.synchronize()
                t = time.perf_counter()
                outputs, banks = model(img, m, banks)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                leaves = list(_flat(outputs)) + [
                    (f"bank.{n}.{f.name}", getattr(getattr(banks, n), f.name))
                    for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))]
                bad = [k for k, v in leaves if v.is_floating_point() and not torch.isfinite(v).all()]
                if bad:
                    fail(f"{dtype} frame {i}: non-finite outputs {bad[:5]}")
                if i < 2:
                    kept.append({k: v.detach().clone() for k, v in leaves})
        launches = {k.name: k.launches for k in kernels.KERNELS}
        timed = sorted(times[WARMUP_FRAMES:])
        p90 = timed[min(len(timed) - 1, int(round(0.9 * (len(timed) - 1))))]
        say(f"[slice] stage2 bs=1 {str(dtype)[6:]} on {card}: {n_frames} chained frames finite; "
            f"per frame median {statistics.median(timed):.2f} ms, p90 {p90:.2f} ms "
            f"(host clock, sync per frame, frames {WARMUP_FRAMES}..{n_frames - 1}); "
            f"frame 0 {times[0]:.1f} ms")
        for name, n in launches.items():
            want = n_frames * n_deform * per_call.get(name, 0)
            say(f"[slice] {str(dtype)[6:]} {name}: {n} launches over {n_frames} frames = "
                f"{n / n_frames:g}/frame (expected {n_deform} deformable calls x "
                f"{per_call.get(name, 0)} = {n_deform * per_call.get(name, 0)}/frame)")
            if n != want or (n == 0 and name in per_call):
                fail(f"{name} launched {n} times, expected {want}")
        return kept, launches

    frames, launches = run_frames(torch.float32)
    frames_bf16, _ = run_frames(torch.bfloat16)
    first = frames[0]
    wp = "plan.final_waypoints"
    for i, rtol in enumerate(BF16_FRAME_RTOL):
        diff = float((frames_bf16[i][wp].float() - frames[i][wp]).abs().max())
        scale = float(frames[i][wp].abs().max())
        say(f"[slice] bf16 vs fp32 frame {i} {wp}: max_abs_diff {diff:.3e}, {diff / scale:.3e} "
            f"of scale (tol {rtol:g} of scale, the spread tests/test_torch_bf16.py allows on "
            f"that frame) {'ok' if diff <= rtol * scale else 'FAIL'}")
        if not diff <= rtol * scale:
            fail(f"the bf16 frame {i}'s {wp} is further from the fp32 frame than the CPU test "
                 f"allows")

    # frame 0 again on the CPU: the plain path
    t0 = time.perf_counter()
    cpu_model = HiPAD(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    img, m = frame_inputs(0)
    with torch.no_grad():
        cpu_out, cpu_banks = cpu_model(img.cpu(), {k: v.cpu() for k, v in m.items()})
    for key in ("plan.final_waypoints", "det.classification", "plan.classification"):
        ref = dict(_flat(cpu_out))[key].double()
        got = first[key].cpu().double()
        diff = (got - ref).abs()
        err = float(diff.max())
        tol = E2E_RTOL * float(ref.abs().max()) + E2E_ATOL
        layers = (" per layer " + " ".join(f"{float(d.max()):.1e}" for d in diff)
                  if diff.dim() == 4 else "")
        say(f"[slice] card frame 0 vs CPU plain path {key} {tuple(ref.shape)}: max_abs_err "
            f"{err:.3e}, median {float(diff.median()):.3e}{layers} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"card and CPU disagree on {key}")
    say(f"[slice] CPU frame took {time.perf_counter() - t0:.1f} s")
    return launches


def _launch_plan(cfg):
    """(deformable calls per forward, launches of each kernel per call): K1
    once for all coarse levels, K2 once for all fine levels, K1-bwd once per
    coarse level and K2-bwd once (with torch's deterministic flag on or
    off: one design each); with ``sampler_level_k`` below the number of fine
    levels, K2's and K2-bwd's level-k variants in their place."""
    n_deform = cfg.operation_order.count("deformable") * len(cfg.query_select)
    coarse = len([l for l in cfg.sampler_matmul_levels if l < cfg.num_levels])
    fine = [l for l in range(cfg.num_levels) if l not in cfg.sampler_matmul_levels]
    lk = "_lk" if cfg.sampler_level_k is not None and 0 < cfg.sampler_level_k < len(fine) else ""
    k2 = int(bool(fine))
    return n_deform, {"coarse_sample": int(coarse > 0), f"patch_sample{lk}": k2,
                      "interp_sample_camsum_bwd": coarse, f"patch_sample_bwd{lk}": k2}


# Card step vs CPU step (plain path), stage 2 at drop_out 0 without GridMask:
# the same fp32 arithmetic in other orders through ResNet-50, the decoder
# layers and the backward (the card's kernels add in their bins' order); the
# losses are sums over every query, the gradient norm a sum of squares over
# 98 M gradients.
# |diff| <= TRAIN_RTOL * |cpu| + TRAIN_ATOL per loss, GRAD_NORM_RTOL for the
# norm. Seen on an H100: <= 7e-7 of each loss, 2.5e-5 of the norm.
TRAIN_RTOL, TRAIN_ATOL, GRAD_NORM_RTOL = 1e-4, 1e-5, 1e-3
WARMUP_STEPS, TIMED_STEPS = 2, 4
# K3 launches per training step: one for the det and the map matrices of
# every decoder layer together (targets/matching.py: assign_many)
MATCH_LAUNCHES = 1
# rounds of one fp32 and one bf16 step in turn, after the warm-up steps
PAIRED_ROUNDS = 2


def phase_train(card: str):
    """The training step at stage 2, bs=1: 2 warm-up and 4 timed steps with
    the banks chained, fp32 then bf16 autocast, dropout 0.1 and GridMask on;
    then fp32 and bf16 steps in turns; then step 0 without dropout and
    GridMask on the card and on the CPU. -> launches of the fp32 run."""
    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.data import synthetic
    from hipad_torch.models.deformable import DeformableAggregation
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.ops import kernels
    from hipad_torch.targets import matching
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2()
    n_deform, per_call = _launch_plan(cfg)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic.make_batch(cfg, 1, seed=SEED).items()}
    n_steps = WARMUP_STEPS + TIMED_STEPS

    def step_batch(i):
        b = dict(batch)
        b["timestamp"] = batch["timestamp"] + 0.5 * i
        b["images"] = batch["images"] + 1e-3 * i
        return b

    def build(c, device):
        model = init_random(HiPAD(c, device=device), SEED)
        return model, AdamW(model.named_parameters())

    def run_steps(dtype):
        model, opt = build(cfg, dev)
        step = make_train_step(cfg, model, opt, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for k in kernels.KERNELS:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        banks, times = None, []
        for i in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            banks, metrics = step(banks, step_batch(i), gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            if bad:
                fail(f"train {dtype} step {i}: non-finite {bad}")
        launches = {k.name: k.launches for k in kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timed = times[WARMUP_STEPS:]
        name = str(dtype)[6:]
        say(f"[train] stage2 bs=1 {name} on {card}: {n_steps} chained steps, every loss, "
            f"total_loss and grad_norm finite; last step total_loss "
            f"{float(metrics['total_loss']):.4f} grad_norm {float(metrics['grad_norm']):.4f}")
        say(f"[train] {name} step time median {statistics.median(timed):.2f} ms, min "
            f"{min(timed):.2f}, max {max(timed):.2f} (host clock, sync per step, steps "
            f"{WARMUP_STEPS}..{n_steps - 1}); step 0 {times[0]:.1f} ms; "
            f"max_memory_allocated {peak:.2f} GiB")
        for kname in per_call:
            n = launches[kname]
            want = n_steps * n_deform * per_call[kname]
            say(f"[train] {name} {kname}: {n} launches over {n_steps} steps = "
                f"{n / n_steps:g}/step (expected {n_deform} deformable calls x "
                f"{per_call[kname]} = {n_deform * per_call[kname]}/step)")
            if n != want or n == 0:
                fail(f"train: {kname} launched {n} times, expected {want}")
        n = launches["lsa_assign"]
        say(f"[train] {name} lsa_assign: {n} launches over {n_steps} steps = {n / n_steps:g}/step "
            f"(expected {MATCH_LAUNCHES}: the det and the map matrices, every layer stacked, "
            f"in one launch)")
        if n != n_steps * MATCH_LAUNCHES:
            fail(f"train: lsa_assign launched {n} times, expected {n_steps * MATCH_LAUNCHES}")
        del model, opt, step
        torch.cuda.empty_cache()
        return launches

    launches = run_steps(torch.float32)
    run_steps(torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        _step_repeats(card, cfg, dtype, build, step_batch, timed=dtype == torch.float32)

    # The host clock of one card varies over a call and from machine to
    # machine, so fp32 and bf16 are compared step by step: two models
    # resident together, one step of each in turn.
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model, opt = build(cfg, dev)
        runs[dtype] = {"step": make_train_step(cfg, model, opt, dtype=dtype), "banks": None,
                       "gen": torch.Generator(device=dev).manual_seed(SEED), "ms": []}
    for i in range(WARMUP_STEPS + PAIRED_ROUNDS):
        for r in runs.values():
            torch.cuda.synchronize()
            t = time.perf_counter()
            r["banks"], _ = r["step"](r["banks"], step_batch(i), r["gen"])
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t) * 1e3)
    fp32_ms, bf16_ms = (r["ms"][WARMUP_STEPS:] for r in runs.values())
    diff = [b - a for a, b in zip(fp32_ms, bf16_ms)]
    say(f"[train] fp32 and bf16 steps in turns, {PAIRED_ROUNDS} rounds after {WARMUP_STEPS} "
        f"(host clock, sync per step): fp32 median {statistics.median(fp32_ms):.2f} ms "
        f"[{min(fp32_ms):.2f}, {max(fp32_ms):.2f}], bf16 median "
        f"{statistics.median(bf16_ms):.2f} ms [{min(bf16_ms):.2f}, {max(bf16_ms):.2f}], "
        f"bf16 - fp32 per round median {statistics.median(diff):.2f} ms "
        f"[{min(diff):.2f}, {max(diff):.2f}]")
    del runs, model, opt
    torch.cuda.empty_cache()

    # step 0 on the card and on the CPU plain path, no dropout, no GridMask
    c0 = stage2(drop_out=0.0, use_grid_mask=False)
    solved = []
    assign_many = matching.assign_many

    def recording(problems):
        cols = assign_many(problems)
        solved.append([c.cpu() for c in cols])
        return cols

    card_model, _ = build(c0, dev)
    # the CPU model takes the card model's weights: init_random draws from
    # each device's own generator
    weights = {k: v.detach().cpu().clone() for k, v in card_model.state_dict().items()}
    del card_model
    matching.assign_many = recording
    try:
        results = []
        for device in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            model = HiPAD(c0, device=device)
            model.load_state_dict(weights)
            opt = AdamW(model.named_parameters())
            for m in model.modules():
                if isinstance(m, DeformableAggregation):
                    m.attn_drop = 0.0
            b = {k: v.to(device) for k, v in batch.items()}
            _, metrics = make_train_step(c0, model, opt)(None, b, torch.Generator(device=device))
            results.append({k: float(v) for k, v in metrics.items()})
            say(f"[train] step 0 (drop_out 0, no GridMask, fp32) on {device.type}: "
                f"{time.perf_counter() - t0:.1f} s, {c0.operation_order.count('refine')} "
                f"decoder layers")
            del model, opt
    finally:
        matching.assign_many = assign_many
    differ = [i for i, (a, b) in enumerate(zip(*solved)) if not torch.equal(a, b)]
    if differ:
        say(f"[train] the Hungarian assignments differ between card and CPU in problem(s) "
            f"{differ} (0 = det, 1 = map, all layers stacked)")
    card_m, cpu_m = results
    for k in sorted(cpu_m):
        rtol, atol = (GRAD_NORM_RTOL, 0.0) if k == "grad_norm" else (TRAIN_RTOL, TRAIN_ATOL)
        err, tol = abs(card_m[k] - cpu_m[k]), rtol * abs(cpu_m[k]) + atol
        say(f"[train] card vs CPU step 0 {k}: card {card_m[k]:.6f} cpu {cpu_m[k]:.6f} "
            f"abs_err {err:.3e} (tol {tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"card and CPU disagree on {k}")
    return launches


def _step_state(model, opt, banks, gen):
    """A copy on the card of what a step starts from: parameters and
    buffers, AdamW's state, the banks and the generator's state."""
    from hipad_torch.models.instance_bank import map_banks

    return ({k: v.detach().clone() for k, v in model.state_dict().items()}, opt.state_dict(),
            map_banks(lambda t: t.detach().clone(), banks), gen.get_state())


def _step_outputs(model, metrics):
    """Copies of a step's losses, every gradient leaf and the parameters
    after its update."""
    return ({k: v.detach().clone() for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().clone() for n, p in model.named_parameters()})


# [train]'s steps in turns with the deterministic flag off and on
FLAG_ROUNDS = 2
# the launches of K1-bwd's and K2-bwd's calls, by kernel name
BWD_KERNEL_NAMES = ("interp_sample_camsum_bwd", "patch_sample_bwd", "bin_scan", "bin_base",
                    "bin_place", "bin_cells")


def _step_repeats(card, cfg, dtype, build, step_batch, timed):
    """Under torch's deterministic flag, one stage-2 step (the config's
    dropout and GridMask) from a saved state (parameters, AdamW's state,
    the banks and the generator after a first step), run twice: its losses,
    every gradient leaf and the parameters after the update held equal bit
    for bit. With ``timed``, then the step with the flag off and on in turns
    (host clock), and one profiled step of each: device busy and launches."""
    import torch

    from hipad_torch.models.instance_bank import map_banks
    from hipad_torch.train.train_step import make_train_step

    dev = torch.device(DEVICE)
    name = str(dtype)[6:]
    model, opt = build(cfg, dev)
    step = make_train_step(cfg, model, opt, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with flag(True):
        banks, _ = step(None, step_batch(0), gen)
        saved = _step_state(model, opt, banks, gen)
        runs = []
        for _ in range(2):
            params, opt_state, bank_copy, gen_state = saved
            model.load_state_dict(params)
            opt.load_state_dict(opt_state)
            gen.set_state(gen_state)
            new_banks, metrics = step(map_banks(torch.clone, bank_copy), step_batch(1), gen)
            runs.append(_step_outputs(model, metrics) + (new_banks,))
    torch.cuda.synchronize()
    (m0, g0, p0, b0), (m1, g1, p1, b1) = runs
    parts = {"losses": (m0, m1), "gradient leaves": (g0, g1), "parameters after the update":
             (p0, p1)}
    for what, (a, b) in parts.items():
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ or set(a) != set(b):
            fail(f"[train] {name} step under the deterministic flag, twice from one state: "
                 f"{len(differ)} of {len(a)} {what} differ ({differ[:5]})")
    if not _bits_equal(tuple(_tensors_of_banks(b0)), tuple(_tensors_of_banks(b1))):
        fail(f"[train] {name} step under the deterministic flag: the new banks differ")
    say(f"[train] stage2 bs=1 {name} step under torch.use_deterministic_algorithms(True), twice "
        f"from one saved state (parameters, AdamW state, banks, generator) on {card}: "
        f"{len(m0)} losses, {len(g0)} gradient leaves, {len(p0)} parameters after the update "
        f"and the new banks equal bit for bit (total_loss {float(m0['total_loss']):.6f}, "
        f"grad_norm {float(m0['grad_norm']):.6f})")
    del runs, saved, m0, g0, p0, m1, g1, p1
    if not timed:
        del model, opt, step
        torch.cuda.empty_cache()
        return

    ms = {False: [], True: []}
    for i in range(FLAG_ROUNDS * 2):
        on = (i % 4) in (1, 2)  # off, on, on, off, ...
        with flag(on):
            torch.cuda.synchronize()
            t = time.perf_counter()
            banks, _ = step(banks, step_batch(2 + i), gen)
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t) * 1e3)
    prof, names = {}, {False: {}, True: {}}
    for on in (False, True):
        with flag(on):
            prof[on] = _profiled(lambda: step(banks, step_batch(9), gen), names[on])
    say(f"[train] {name} step with the flag off / on in turns ({FLAG_ROUNDS} rounds each, host "
        f"clock, sync per step): off median {statistics.median(ms[False]):.2f} ms "
        f"[{min(ms[False]):.2f}, {max(ms[False]):.2f}], on {statistics.median(ms[True]):.2f} ms "
        f"[{min(ms[True]):.2f}, {max(ms[True]):.2f}]; one profiled step each (torch.profiler): "
        f"off {prof[False][0]} launches, {prof[False][1]:.2f} ms device busy; on "
        f"{prof[True][0]} launches, {prof[True][1]:.2f} ms device busy")
    rows = sorted(((names[True].get(k, [0, 0.0])[1] - names[False].get(k, [0, 0.0])[1],
                    names[True].get(k, [0])[0] - names[False].get(k, [0])[0], k)
                   for k in set(names[False]) | set(names[True])),
                  key=lambda r: -abs(r[0]))
    say(f"[train] {name} the flag's largest changes by kernel (on - off, the profiled steps): "
        + "; ".join(f"{dn:+d} launches {dms:+.3f} ms {k[:90]}" for dms, dn, k in rows[:12]))
    for on in (False, True):  # the sampler's backward kernels in the profiled step
        mine = sorted(((ms, n, k) for k, (n, ms) in names[on].items()
                       if any(t in k for t in BWD_KERNEL_NAMES)), reverse=True)
        say(f"[train] {name} the sampler's backward kernels in the profiled step, flag "
            f"{'on' if on else 'off'}: {sum(r[0] for r in mine):.3f} ms, "
            f"{sum(r[1] for r in mine)} launches; "
            + "; ".join(f"{n} launches {ms:.3f} ms {k[:70]}" for ms, n, k in mine))
    fills = [r for r in rows if "FillFunctor" in r[2]]
    say(f"[train] {name} of them the fills of torch.empty under the flag "
        f"(torch.utils.deterministic.fill_uninitialized_memory): "
        f"{sum(r[1] for r in fills):+d} launches, {sum(r[0] for r in fills):+.3f} ms")
    del model, opt, step
    torch.cuda.empty_cache()


def _tensors_of_banks(banks):
    import dataclasses

    return [getattr(getattr(banks, n), f.name) for n in ("det", "ego", "plan")
            for f in dataclasses.fields(getattr(banks, n))]


# K3 against scipy: the totals of two optimal assignments summed in float64
# from the same fp32 costs in other orders: |diff| <= MATCH_TOTAL_RTOL * sum
# |assigned costs|.
MATCH_TOTAL_RTOL = 1e-9


def _planted_problems(g, dev):
    """Seeded costs for K3 on the card: a coarse integer grid (exact ties
    everywhere) with NaN and +-inf entries planted, one all-invalid matrix,
    [6, 32, 900] and [6, 24, 100] as a stage-2 step's det and map
    matrices, 32 valid rows for 12 columns (tiny()'s det anchors), and
    [2, 64, 1000], whose costs do not fit shared memory (kernels.lsa_plan):
    K3 reads them from global memory, two columns a thread."""
    import torch

    out = []
    for n, R, C in ((6, 32, 900), (6, 24, 100), (4, 32, 12), (2, 64, 1000)):
        cost = torch.randint(0, 6, (n, R, C), generator=g, device=dev).float()
        flat = cost.view(-1)
        idx = torch.randint(0, flat.numel(), (3, 8), generator=g, device=dev)
        flat[idx[0]] = float("nan")
        flat[idx[1]] = float("inf")
        flat[idx[2]] = -float("inf")
        mask = torch.rand(n, R, generator=g, device=dev) < 0.7
        mask[0] = False
        mask[-1] = True
        out.append((f"planted [{n}, {R}, {C}]", cost, mask))
    return out


# [match]'s calls past K3's old limits: 9 problems of mixed shapes in one
# assign_many call (the register kernel's and the strip kernel's, more than
# the 8 a launch takes), and two matrices past 4,096 padded columns
MIXED_SHAPES = ((2, 5, 7), (1, 32, 900), (3, 12, 40), (1, 40, 3000), (2, 24, 100),
                (1, 64, 1000), (2, 8, 2100), (1, 3, 3), (2, 16, 700))
LARGE_SHAPES = ((8, 64, 6000), (1, 32, 20000))


def _large_problems(g, dev):
    """-> (what, problems) pairs: the 9 mixed problems (integer costs with
    exact ties, NaN and +-inf planted, 70% of rows valid), then one call
    each of ``[8, 64, 6000]`` (N = 6,065: the strip kernel, its state in
    shared memory; continuous costs) and ``[1, 32, 20000]`` (N = 20,033:
    its state in global memory; integer costs)."""
    import torch

    def problem(shape, ties):
        n, R, C = shape
        if ties:
            cost = torch.randint(0, 6, shape, generator=g, device=dev).float()
            flat = cost.view(-1)
            idx = torch.randint(0, flat.numel(), (3, 4), generator=g, device=dev)
            flat[idx[0]] = float("nan")
            flat[idx[1]] = float("inf")
            flat[idx[2]] = -float("inf")
        else:
            cost = torch.rand(shape, generator=g, device=dev) * 20
        mask = torch.rand(n, R, generator=g, device=dev) < 0.7
        mask[-1, 0] = True
        return cost, mask

    out = [(f"{len(MIXED_SHAPES)} mixed problems in one call",
            [problem(sh, True) for sh in MIXED_SHAPES])]
    for sh, ties in zip(LARGE_SHAPES, (False, True)):
        out.append((f"{list(sh)} (N = {sh[1] + sh[2] + 1})", [problem(sh, ties)]))
    return out


def _sanitised(cost):
    """The costs on the host in float64 as the matcher reads them: NaN and
    +inf -> 1e3, -inf -> -1e3, clipped to +-1e3."""
    import numpy as np

    c = cost.cpu().numpy().astype(np.float64)
    return np.clip(np.nan_to_num(c, nan=1e3, posinf=1e3, neginf=-1e3), -1e3, 1e3)


def _scipy_cols(cost, mask):
    """scipy's optimum of the sanitised costs (host, float64) -> col4row
    [n, R] numpy; the device-to-host copy included."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    c, m = _sanitised(cost), mask.cpu().numpy()
    out = np.full(m.shape, -1, np.int32)
    for b in range(len(c)):
        rows = np.flatnonzero(m[b])
        if rows.size:
            r, col = linear_sum_assignment(c[b, rows])
            out[b, rows[r]] = col
    return out


def _check_against_scipy(what, cost, mask, got):
    """Each valid row on a distinct real column where it fits, invalid rows
    -1, each matrix's total within MATCH_TOTAL_RTOL of scipy's -> the
    largest relative gap."""
    import numpy as np

    ref = _scipy_cols(cost, mask)
    c, m, got = _sanitised(cost), mask.cpu().numpy(), got.cpu().numpy()
    worst = 0.0
    for b in range(len(c)):
        if (got[b][~m[b]] != -1).any():
            fail(f"[match] {what} matrix {b}: an invalid row was assigned")
        sel = got[b] >= 0
        taken = got[b][sel]
        if len(set(taken.tolist())) != len(taken) or sel.sum() != (ref[b] >= 0).sum():
            fail(f"[match] {what} matrix {b}: not an assignment of {(ref[b] >= 0).sum()} rows")
        rows = np.arange(len(got[b]))
        mine = c[b, rows[sel], taken]
        theirs = c[b, rows[ref[b] >= 0], ref[b][ref[b] >= 0]]
        gap = abs(mine.sum() - theirs.sum()) / max(np.abs(theirs).sum(), 1e-30)
        worst = max(worst, gap)
        if gap > MATCH_TOTAL_RTOL:
            fail(f"[match] {what} matrix {b}: total {mine.sum()!r} against scipy's "
                 f"{theirs.sum()!r}")
    return worst


def _sync_sites(fn):
    """Run fn under ``torch.cuda.set_sync_debug_mode("warn")`` -> {call site:
    count} of the synchronizing calls it made, each site the innermost frame
    in the port (else the innermost frame). A warning raised outside fn (the
    one ``set_sync_debug_mode`` itself gives in some runs) is not fn's and is
    not counted."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    inside = False

    def show(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not os.path.basename(f.filename).startswith("warnings")]
        port = [f for f in frames if f"{os.sep}hipad_torch{os.sep}" in f.filename]
        f = (port or frames)[-1]
        sites[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        inside = True
        try:
            fn()
        finally:
            inside = False
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def count_step_syncs(tag, step, batch, card):
    """The synchronizing calls of one stage-2 fp32 training step (after one
    warm-up step) -> {call site: count}."""
    import torch

    gen = torch.Generator(device=batch["images"].device).manual_seed(SEED)
    banks, _ = step(None, batch, gen)
    torch.cuda.synchronize()
    sites = _sync_sites(lambda: step(banks, batch, gen))
    total = sum(sites.values())
    say(f"[syncs] {tag} one stage-2 fp32 training step on {card}: {total} synchronizing "
        f"calls (torch.cuda.set_sync_debug_mode('warn')) at {len(sites)} call sites:")
    for site, n in sites.most_common():
        say(f"[syncs]   {n:5d}  {site}")
    return sites


# K3's operations term: fp64 operations a padded column costs in one inner
# iteration (the reduced cost's two subtractions, its comparison with minv,
# the argmin's comparison, the dual update's add or subtract), over the H100
# SXM's fp64 rate outside the tensor cores (NVIDIA's data sheet, 700 W)
K3_OPS_PER_COLUMN = 5
FP64_FLOP_PER_S = 34e12


def _k3_bound(problems, iterations):
    """K3's bound on ``problems`` whose matrices took ``iterations`` (one
    list per problem, one count per matrix) -> ((ms, by), bytes, fp64 ops):
    the cost, mask and out once over the HBM rate, or the fp64 operations
    those iterations need over the fp64 rate, the larger."""
    nbytes = sum(_nbytes(c, m) + m.numel() * 4 for c, m in problems)
    ops = sum(K3_OPS_PER_COLUMN * (c.shape[1] + c.shape[2] + 1) * sum(it)
              for (c, _), it in zip(problems, iterations))
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_FLOP_PER_S * 1e3
    return ((tb, "bytes") if tb >= to else (to, "operations")), nbytes, ops


def _iters(counts):
    return f"{min(counts)}/{statistics.median(counts):g}/{max(counts)}"


def step_problems(cfg, bs_list=(1, 2)):
    """The det and map cost matrices of one stage-2 fp32 training step at
    each bs, as the step hands them to ``assign_many`` -> ({bs: problems},
    {bs: K3 launches in that step}, the step, {bs: batch})."""
    import torch

    from hipad_torch.data import synthetic
    from hipad_torch.losses import hipad_loss
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.ops import kernels
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    model = init_random(HiPAD(cfg, device=dev), SEED)
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    seen, launches, batches = {}, {}, {}
    assign_many = hipad_loss.matching.assign_many

    def recording(problems):
        seen[bs] = [(c.detach().float().contiguous().clone(), m.bool().contiguous().clone())
                    for c, m in problems]
        return assign_many(problems)

    hipad_loss.matching.assign_many = recording
    try:
        for bs in bs_list:
            batches[bs] = {k: torch.as_tensor(v, device=dev)
                           for k, v in synthetic.make_batch(cfg, bs, seed=SEED).items()}
            before = kernels.lsa_assign.launches
            step(None, batches[bs], torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            launches[bs] = kernels.lsa_assign.launches - before
    finally:
        hipad_loss.matching.assign_many = assign_many
    return seen, launches, step, batches


def phase_match(card: str):
    """K3: the cost matrices of a stage-2 fp32 step at bs=1 and bs=2 and the
    planted cases (one above the shared-memory staging limit), K3 against
    ``assign_plain`` on the card (bit for bit) and against
    scipy on the host (totals), with the inner iterations each matrix takes;
    the step's problems in one launch; K3's device time per step and per
    iteration, time per call, the plain version's, scipy's with the copy and
    its bound; the step's synchronizing calls by call site, none of them the
    matcher's; ``assign_many`` under ``set_sync_debug_mode("error")``."""
    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.ops import kernels
    from hipad_torch.targets import matching

    dev = torch.device(DEVICE)
    seen, launches, step, batches = step_problems(stage2())
    for bs, probs in seen.items():
        say(f"[match] stage2 fp32 step bs={bs}: {launches[bs]} K3 launch(es) for "
            f"{len(probs)} problems ({', '.join(str(tuple(c.shape)) for c, _ in probs)})")
        if launches[bs] != MATCH_LAUNCHES or len(probs) != 2:
            fail(f"[match] bs={bs}: {launches[bs]} K3 launches for {len(probs)} problems, "
                 f"expected {MATCH_LAUNCHES} for 2")
    cases = [(f"step bs={bs} {kind} {tuple(c.shape)}", c, m)
             for bs, probs in seen.items() for kind, (c, m) in zip(("det", "map"), probs)]
    cases += _planted_problems(torch.Generator(device=dev).manual_seed(SEED), dev)
    refs, iterations = {}, {}
    for what, cost, mask in cases:
        cols, threads, staged, smem, _ = kernels.lsa_plan(*cost.shape[1:])
        iterations[what] = []
        refs[what] = ref = matching.assign_plain(cost, mask, iterations[what])
        got = kernels.lsa_assign([(cost, mask)])[0]
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"[match] {what}: K3 differs from assign_plain in {int((got != ref).sum())} "
                 f"rows")
        gap = _check_against_scipy(what, cost, mask, ref)
        say(f"[match] {what}: K3 equals assign_plain bit for bit; costs in "
            f"{'shared' if staged else 'global'} memory ({smem} B a block, {threads} threads x "
            f"{cols} column(s)); valid rows {int(mask.sum())}, assigned "
            f"{int((ref >= 0).sum())}; inner iterations per matrix min/median/max "
            f"{_iters(iterations[what])}; total vs scipy rel gap {gap:.2e} "
            f"(tol {MATCH_TOTAL_RTOL:g}) ok")
    for bs, probs in seen.items():
        got = matching.assign_many(probs)
        keys = [f"step bs={bs} {kind} {tuple(c.shape)}" for kind, (c, _) in zip(("det", "map"),
                                                                                 probs)]
        if not all(torch.equal(g_, refs[k]) for g_, k in zip(got, keys)):
            fail(f"[match] bs={bs}: the step's problems in one launch differ from assign_plain")
        say(f"[match] bs={bs}: det and map in one launch (assign_many) equal assign_plain "
            f"bit for bit")

    # past K3's old limits: more than 8 problems a call, more than 4,096
    # padded columns a matrix
    for what, probs in _large_problems(torch.Generator(device=dev).manual_seed(SEED + 3), dev):
        before = kernels.lsa_assign.launches
        got = matching.assign_many(probs)
        torch.cuda.synchronize()
        n_launch = kernels.lsa_assign.launches - before
        its, worst = [], 0.0
        for i, ((cost, mask), cols) in enumerate(zip(probs, got)):
            ref = matching.assign_plain(cost, mask, its)
            if not torch.equal(cols, ref):
                fail(f"[match] {what} problem {i} {tuple(cost.shape)}: K3 differs from "
                     f"assign_plain in {int((cols != ref).sum())} rows")
            worst = max(worst, _check_against_scipy(f"{what} problem {i}", cost, mask, ref))
        plans = [kernels.lsa_plan(*c.shape[1:]) for c, _ in probs]
        ms = min(_device_ms([lambda p=probs: matching.assign_many(p)] * 2))
        say(f"[match] {what}: {', '.join(str(tuple(c.shape)) for c, _ in probs)}; K3 equals "
            f"assign_plain bit for bit on each, in the caller's order; totals vs scipy rel gap "
            f"<= {worst:.2e} (tol {MATCH_TOTAL_RTOL:g}); {n_launch} K3 launch(es) (plans "
            f"{', '.join(f'cols={q.cols} smem={q.smem} scratch={q.scratch}' for q in plans)}); "
            f"inner iterations per matrix min/median/max {_iters(its)}; {ms:.4f} ms on {card} "
            f"({QUEUED}, the better of two)")
        if n_launch != len(kernels.lsa_launches(plans)):
            fail(f"[match] {what}: {n_launch} K3 launches, expected "
                 f"{len(kernels.lsa_launches(plans))}")

    # times at bs=1: the step's one launch
    probs = seen[1]
    keys = [f"step bs=1 {kind} {tuple(c.shape)}" for kind, (c, _) in zip(("det", "map"), probs)]
    its = [iterations[k] for k in keys]
    chain = max(max(it) for it in its)

    def k3(problems):
        return lambda: matching.assign_many(problems)

    dev_ms = _device_ms([k3(probs), k3(probs)])
    call_ms = _timed([k3(probs), k3(probs)])
    alone = [min(_device_ms([k3([p]), k3([p])])) for p in probs]
    plain_ms = sum(cuda_time_ms(lambda c=c, m=m: matching.assign_plain(c, m), 3)
                   for c, m in probs)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, m in probs:
            _scipy_cols(c, m)
        host.append((time.perf_counter() - t0) * 1e3)
    (bms, by), nbytes, ops = _k3_bound(probs, its)
    rec = _Rec()
    rec.ms = min(dev_ms)
    rec.per_call_ms = min(call_ms)
    rec.plain_ms = plain_ms
    rec.library_ms = statistics.median(host)
    rec.add_bound((bms, by))
    say(f"[match] K3 per stage-2 step (bs=1: det {tuple(probs[0][0].shape)} and map "
        f"{tuple(probs[1][0].shape)} in one launch) on {card}: {rec.ms:.4f} ms ({QUEUED}, the "
        f"better of two); the longest chain {chain} inner iterations (det {_iters(its[0])}, map "
        f"{_iters(its[1])} per matrix): {rec.ms / chain * 1e3:.3f} us an iteration; det alone "
        f"{alone[0]:.4f} ms, map alone {alone[1]:.4f} ms (one launch each); per call "
        f"{rec.per_call_ms:.4f} ms")
    say(f"[match] K3 plain (syncs each iteration: CUDA events around one call per problem, "
        f"median of 3) {plain_ms:.2f} ms; scipy with the device-to-host copy (host clock, "
        f"median of 5) {rec.library_ms:.3f} ms; bound {bms:.6f} ms ({by}: {nbytes} B of cost, "
        f"mask and out over {HBM_BYTES_PER_S / 1e12:g} TB/s; {ops:.4g} fp64 operations, "
        f"{K3_OPS_PER_COLUMN} per padded column of each iteration, over "
        f"{FP64_FLOP_PER_S / 1e12:g} TFLOP/s)")

    # the register kernel against the strip kernel on the step's problems
    # (kernels.lsa_plan sends matrices to the strips above 2,048 columns)
    plan = kernels.lsa_plan

    def strips(R, C):
        state = (9 * R + 25 * (C + R + 1) + 15) // 16 * 16
        return kernels.LsaPlan(0, 1024, False, 768 + state, 0)

    kernels.lsa_plan = strips
    try:
        got = matching.assign_many(probs)
        if not all(torch.equal(g_, refs[k]) for g_, k in zip(got, keys)):
            fail("[match] the strip kernel differs from assign_plain on the step's problems")
        strip_ms = _device_ms([k3(probs), k3(probs)])
    finally:
        kernels.lsa_plan = plan
    reg_ms = _device_ms([k3(probs)])[0]
    say(f"[match] the step's problems (bs=1) through the strip kernel, forced: "
        f"{min(strip_ms):.4f} ms against the register kernel's {reg_ms:.4f} ms on {card} "
        f"({QUEUED}); bit for bit with assign_plain")

    sites = count_step_syncs("ours:", step, batches[1], card)
    mine = [s for s in sites if "targets/matching.py" in s or "ops/kernels.py" in s]
    if mine:
        fail(f"[syncs] the matcher synchronizes: {mine}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        matching.assign_many(seen[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say("[syncs] assign_many on the card ran under set_sync_debug_mode('error') without raising")
    del step
    torch.cuda.empty_cache()
    return {"lsa_assign": rec}

CLI_STEPS, CLI_ACCUM, CLI_RESUME_AT = 4, 2, 2


def _kernel_counts():
    from hipad_torch.ops import kernels

    return {k.name: k.launches for k in kernels.KERNELS}


def _reset_counts():
    from hipad_torch.ops import kernels

    for k in kernels.KERNELS:
        k.launches = 0


def _flat_params(model):
    import torch

    return torch.cat([p.detach().flatten() for p in model.parameters()])


def _train_state(model, opt, banks, gen):
    """A copy in host memory of what a checkpoint holds: parameters and
    buffers, AdamW's moments and count, the banks (a list for accumulation)
    and the generator's state; and the parameters flat, in the model's
    order."""
    import dataclasses

    def host(t):
        return t.detach().to("cpu", copy=True)

    bank_list = banks if isinstance(banks, (list, tuple)) else [banks]
    return {"model": {k: host(v) for k, v in model.state_dict().items()},
            "mu": [host(t) for t in opt.mu], "nu": [host(t) for t in opt.nu],
            "count": opt.count,
            "banks": {f"{i}.{n}.{f.name}": host(getattr(getattr(b, n), f.name))
                      for i, b in enumerate(bank_list) for n in ("det", "ego", "plan")
                      for f in dataclasses.fields(getattr(b, n))},
            "gen": gen.get_state(), "params": host(_flat_params(model))}


def phase_train_cli(card: str):
    """``python -m hipad_torch.tools.train`` (its ``main``, in this process)
    at stage-2 width on the card, bf16 autocast (the CLI's compute dtype),
    global batch 1 with 2 micro-batches per step; the CLI runs under torch's
    deterministic flag, so the run repeats itself bit for bit. The unbroken
    run of 4 steps gives the launches per optimizer step, step time and
    peak memory; then ``--resume`` from the unbroken run's own step-2
    checkpoint runs steps 3 and 4 in another work dir. Held, in this
    process, bit for bit: the state the resume restored (parameters,
    buffers, AdamW's moments and count, banks, generator) against the
    unbroken run's state at step 2; the parameters after step 3 against
    the unbroken run's; and steps 3 and 4's metrics (every loss,
    ``total_loss``, ``grad_norm``) against the unbroken run's. ->
    (the unbroken run's launches, its work dir, whose step-4 checkpoint
    ``[eval]`` evaluates)."""
    import shutil

    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.tools import train
    from hipad_torch.train import checkpoint

    work = os.path.join(ROOT, "work_dirs", "chip_smoke_train_cli")
    shutil.rmtree(work, ignore_errors=True)
    args = ["--accum-steps", str(CLI_ACCUM), "--ckpt-interval", str(CLI_RESUME_AT),
            "--batch-size", "1", "--log-interval", "1", "--seed", str(SEED),
            "--synthetic", str(CLI_STEPS)]
    save, restore, make_step = (checkpoint.save_checkpoint, checkpoint.restore_checkpoint,
                                train.make_accum_train_step)
    kept = {}  # what the hooks below copy out of the two runs

    def save_hook(ckpt_dir, step, model, opt, banks=None, gen=None, **kw):
        path = save(ckpt_dir, step, model, opt, banks, gen, **kw)
        if step == CLI_RESUME_AT and "saved" not in kept:
            # the CLI's peak before the copies below and in step_and_keep;
            # steps 3-4 have the shapes of steps 1-2
            kept["peak"] = torch.cuda.max_memory_allocated()
            kept["saved"] = _train_state(model, opt, banks, gen)
            # the CLI keeps only its newest checkpoint: link this one aside
            shutil.copytree(os.path.dirname(path), f"{work}/resumed/{step}",
                            copy_function=os.link)
        return path

    def restore_hook(ckpt_dir, model, opt, gen=None, step=None):
        restored = restore(ckpt_dir, model, opt, gen, step)
        kept["restored"] = _train_state(model, opt, restored["banks"], gen)
        return restored

    def make_step_hook(cfg, model, opt, *a, **kw):
        step_fn = make_step(cfg, model, opt, *a, **kw)

        def step_and_keep(banks, data, gen):
            out = step_fn(banks, data, gen)
            if opt.count == CLI_RESUME_AT + 1:  # one copy on the card, kept
                kept.setdefault("after", []).append(_flat_params(model))
            return out

        return step_and_keep

    checkpoint.save_checkpoint, checkpoint.restore_checkpoint = save_hook, restore_hook
    train.make_accum_train_step = make_step_hook
    try:
        _reset_counts()
        t0 = time.perf_counter()
        whole = train.main(args + ["--work-dir", f"{work}/whole"])
        launches = _kernel_counts()
        whole_s = time.perf_counter() - t0
        rest = train.main(args + ["--work-dir", f"{work}/resumed", "--resume"])
    finally:
        checkpoint.save_checkpoint, checkpoint.restore_checkpoint = save, restore
        train.make_accum_train_step = make_step
    say(f"[train-cli] python -m hipad_torch.tools.train {' '.join(args)} (stage 2, bf16 "
        f"autocast) on {card}: {whole_s:.1f} s; step ms {[round(t, 2) for t in whole['step_ms']]} "
        f"(host clock, the first includes warm-up); median of steps 2..{CLI_STEPS} "
        f"{statistics.median(whole['step_ms'][1:]):.2f} ms; max_memory_allocated over steps "
        f"1..{CLI_RESUME_AT} {kept['peak'] / 2 ** 30:.2f} GiB")
    bad = [k for r in (whole, rest) for m in r["metrics"] for k, v in m.items()
           if not math.isfinite(v)]
    if bad:
        fail(f"train-cli: non-finite {bad}")
    n_deform, per_call = _launch_plan(stage2())
    for name, per in per_call.items():
        want = CLI_STEPS * CLI_ACCUM * n_deform * per
        say(f"[train-cli] {name}: {launches[name]} launches over {CLI_STEPS} optimizer steps = "
            f"{launches[name] / CLI_STEPS:g}/step (expected {CLI_ACCUM} micro-steps x "
            f"{n_deform} deformable calls x {per})")
        if launches[name] != want or want == 0:
            fail(f"train-cli: {name} launched {launches[name]} times, expected {want}")
    if rest["start"] != CLI_RESUME_AT or len(rest["metrics"]) != CLI_STEPS - CLI_RESUME_AT:
        fail(f"train-cli: --resume started at step {rest['start']}, expected {CLI_RESUME_AT}")

    # the restored state against the unbroken run's at step 2, bit for bit
    saved, got = kept["saved"], kept["restored"]
    for part in ("model", "banks"):
        differ = [k for k in saved[part] if not torch.equal(saved[part][k], got[part][k])]
        if differ or set(saved[part]) != set(got[part]):
            fail(f"train-cli: --resume restored {part} tensors that differ from the unbroken "
                 f"run's at step {CLI_RESUME_AT}: {differ[:5]}")
    for part in ("mu", "nu"):
        differ = [i for i, (a, b) in enumerate(zip(saved[part], got[part]))
                  if not torch.equal(a, b)]
        if differ or len(saved[part]) != len(got[part]):
            fail(f"train-cli: --resume restored AdamW {part} tensors {differ[:5]} unlike the "
                 f"unbroken run's")
    if got["count"] != saved["count"] or not torch.equal(got["gen"], saved["gen"]):
        fail(f"train-cli: --resume restored count {got['count']} (unbroken: {saved['count']}) "
             f"or a generator state unlike the unbroken run's")
    say(f"[train-cli] --resume restored step {CLI_RESUME_AT} bit for bit as the unbroken run "
        f"held it: {len(got['model'])} parameter and buffer tensors, AdamW mu and nu "
        f"({len(got['mu'])} tensors each), count {got['count']}, {len(got['banks'])} bank "
        f"tensors ({CLI_ACCUM} bank slices), the generator's state")

    if len(kept.get("after", [])) != 2:
        fail(f"train-cli: AdamW's count reached {CLI_RESUME_AT + 1} in "
             f"{len(kept.get('after', []))} of the two runs")
    if not torch.equal(got["params"], saved["params"]):
        fail("train-cli: the restored parameters, flat, differ from the unbroken run's")
    after = [a.cpu() for a in kept["after"]]
    if not torch.equal(*after):
        fail(f"train-cli: the parameters after step {CLI_RESUME_AT + 1} differ from the "
             f"unbroken run's in {int((after[0] != after[1]).sum())} elements (largest "
             f"{float((after[0] - after[1]).abs().max()):.3e})")
    say(f"[train-cli] parameters after step {CLI_RESUME_AT + 1}, the first after --resume: "
        f"{after[0].numel()} values equal to the unbroken run's bit for bit (update norm "
        f"{float((after[0] - saved['params']).norm()):.4e})")
    for i, (a, b) in enumerate(zip(rest["metrics"], whole["metrics"][CLI_RESUME_AT:])):
        differ = [k for k in b if a.get(k) != b[k]]
        if differ or set(a) != set(b):
            fail(f"train-cli: step {CLI_RESUME_AT + 1 + i} after --resume differs from the "
                 f"unbroken run's in {differ[:5]}: " + ", ".join(
                     f"{k} {a.get(k)!r} against {b[k]!r}" for k in differ[:3]))
        say(f"[train-cli] step {CLI_RESUME_AT + 1 + i} after --resume equals the unbroken run's "
            f"bit for bit: {len(b)} metrics (total_loss {b['total_loss']!r}, grad_norm "
            f"{b['grad_norm']!r})")
    kept.clear()
    shutil.rmtree(f"{work}/resumed", ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, f"{work}/whole"


# [eval]: the open-loop eval over a synthetic val split with camera files.
# 80 frames per route: planning scores only frames with 1 s of past and 3 s
# of future in their route (frames 10-49; 16 frames per route would leave
# none). The first 16 dataset frames (split_group interleaving: frames 0, 5,
# ..., 75 of route 0, two sequences of 8) hold 8 of them.
EVAL_ROUTES, EVAL_FRAMES_PER_ROUTE, EVAL_FRAMES = 2, 80, 16
EVAL_TASKS = ["--eval-det", "--eval-map", "--eval-motion"]
# two ranks against one: tests/test_eval_runner.py's bound (the same forwards)
RANKS_REL, RANKS_ABS = 1e-6, 1e-8
# batched (bs=2) against streaming (bs=1), both fp32 through the runner with
# TF32 off: tests/test_eval_runner.py's rel 1e-4, abs 1e-5 (a bs=2 forward
# may take other GEMM and convolution algorithms: the same products summed
# in other orders). Each float of a per-frame record lies within EVAL_REL of
# the largest magnitude of its reference array plus EVAL_ABS, each summary
# metric within EVAL_REL of itself plus EVAL_ABS, and the picks (class
# names, labels) are equal row for row, but in a run of near-tied scores:
# two scores that each move by at most their tolerance can change places
# only if they lie within twice it. The rows of such a run may come in
# another order, each matched to a row within tolerance, and at the end of a
# list cut to its top k another candidate may take the last places. Every
# such run is printed with its largest gap. (Every prediction list is cut:
# detections and their motion to the top 300 of 900 anchors, map lines to
# the top 100 of 100 anchors x 4 classes.)
EVAL_REL, EVAL_ABS = 1e-4, 1e-5
LOADER_STEPS, LOADER_EVAL_FRAMES = 2, 8


def _eval_split(work: str):
    """``tools/make_synthetic_val.py`` (a subprocess), then a seeded
    1600x900 JPEG for every camera of the first EVAL_FRAMES frames, so the
    loader decodes files and runs ``native.preprocess_cameras``. -> (info
    pickle, map pickle, data root)."""
    import io

    import numpy as np
    from PIL import Image

    from hipad_torch.configs.model import stage2
    from hipad_torch.tools.test import open_dataset

    out = os.path.join(work, "split")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synthetic_val.py"),
                          "--routes", str(EVAL_ROUTES), "--frames-per-route",
                          str(EVAL_FRAMES_PER_ROUTE), "--out-dir", out],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"eval: make_synthetic_val.py failed: {res.stderr[-2000:]}")
    ann, mp, root = f"{out}/b2d_infos_val.pkl", f"{out}/b2d_map_infos.pkl", f"{out}/data"
    dataset = open_dataset(stage2(), ann, mp, root, test_mode=True)
    rng = np.random.RandomState(SEED)
    jpegs = {}  # (camera, frame parity) -> bytes: smooth seeded scenes, encoded once
    for i in range(EVAL_FRAMES):
        for c, path in enumerate(dataset.get_data_info(i)["img_filename"]):
            if (c, i % 2) not in jpegs:
                low = Image.fromarray(rng.randint(0, 256, (9, 16, 3), dtype=np.uint8))
                img = np.asarray(low.resize((1600, 900), Image.BILINEAR), np.int16)
                img = np.clip(img + rng.randint(-12, 13, img.shape), 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=90)
                jpegs[(c, i % 2)] = buf.getvalue()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(jpegs[(c, i % 2)])
    return ann, mp, root


def _entries(value):
    import numpy as np

    return {k: np.asarray(v) for k, v in value.items()}


def _records_close(got, ref):
    """Per-frame records of two fp32 runs on the same frames, under the rule
    above -> ({list.field: largest error / tolerance}, [(list, frame, first
    row, rows, largest gap, rows exchanged at the end) of each run that came
    in another order], [each disagreement])."""
    import numpy as np

    worst, moved, bad = {}, [], []

    def err(a, b):
        d = np.abs(a.astype(np.float64) - b)
        return d.reshape(len(d), -1).max(1) if d.ndim > 1 else d

    for key, ref_list in ref.items():
        if not isinstance(ref_list, list) or key in ("frames", "load_s", "forward_s"):
            continue
        r, g = dict(ref_list), dict(got[key])
        if sorted(g) != sorted(r):
            bad.append(f"{key}: other frames")
            continue
        for idx in sorted(r):
            rv, gv = _entries(r[idx]), _entries(g[idx])
            if gv.keys() != rv.keys() or any(gv[n].shape != b.shape for n, b in rv.items()):
                bad.append(f"{key} frame {idx}: other fields or shapes")
                continue
            tol = {n: EVAL_REL * (float(np.abs(b).max()) if b.size else 0.0) + EVAL_ABS
                   for n, b in rv.items() if b.dtype.kind == "f"}
            if "scores" not in rv:  # ground truth, planning: whole arrays
                for n, b in rv.items():
                    e = float(err(gv[n][None], b[None]).max()) if n in tol and b.size else 0.0
                    worst[f"{key}.{n}"] = max(worst.get(f"{key}.{n}", 0.0),
                                              e / tol[n] if n in tol else 0.0)
                    if e > tol.get(n, 0.0) or n not in tol and not np.array_equal(gv[n], b):
                        bad.append(f"{key} frame {idx} {n}")
                continue
            s = rv["scores"]
            cuts = np.flatnonzero(np.abs(np.diff(s)) > 2 * tol["scores"]) + 1
            for run in np.split(np.arange(len(s)), cuts):
                free, place, lost = np.ones(len(run), bool), [], []
                for i in run:
                    ok, ratio = free.copy(), {}
                    for n, b in rv.items():
                        if n in tol:
                            ratio[n] = err(gv[n][run], b[i][None]) / tol[n]
                            ok &= ratio[n] <= 1
                        else:
                            ok &= gv[n][run] == b[i]
                    j = np.flatnonzero(ok)
                    if not j.size:
                        lost.append(i)
                        continue
                    free[j[0]] = False
                    place.append(run[j[0]] == i)
                    for n, x in ratio.items():
                        worst[f"{key}.{n}"] = max(worst.get(f"{key}.{n}", 0.0), float(x[j[0]]))
                gap = float(np.abs(np.diff(s[run])).max()) if len(run) > 1 else 0.0
                # a candidate from past the cut took a last place: both its
                # score and the one it displaced lie within twice the
                # tolerance of their list's last
                took = gv["scores"][run][free]
                if lost and (run[-1] != len(s) - 1 or s[lost].max() > s[-1] + 2 * tol["scores"]
                             or took.max() > gv["scores"][-1] + 2 * tol["scores"]):
                    bad.append(f"{key} frame {idx}: rows {run[0]}-{run[-1]} (gap {gap:.1e}) "
                               f"unmatched")
                elif lost or not all(place):
                    moved.append((key, idx, int(run[0]), len(run), gap, len(lost)))
    return worst, moved, bad


def _flat_summary(summary):
    return {f"{k}/{m}": float(x) for k, d in summary.items() for m, x in d.items()}


def phase_eval(card: str, ckpt: str):
    """The open-loop eval at stage 2 on the ``[train-cli]`` run's step-4
    checkpoint, over a synthetic split with camera files: the runner in
    fp32, streaming (its frame 0 against a direct ``HiPAD.forward`` +
    ``post_process``, bit for bit) and batched against streaming; then
    ``python -m hipad_torch.tools.test`` (its ``main``, bf16) streaming,
    with ``--batch-slots 2 --num-workers 2``, and as two ranks through one
    gather dir; then ``python -m hipad_torch.tools.train`` on the split's
    loader with an eval. -> (launches of the streaming CLI run, launches of
    the loader-driven training)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from hipad_torch import postprocess
    from hipad_torch.configs.model import stage2
    from hipad_torch.eval import runner
    from hipad_torch.models.detector import META_KEYS, HiPAD
    from hipad_torch.tools import test as eval_cli
    from hipad_torch.tools import train
    from hipad_torch.train import checkpoint

    work = os.path.join(ROOT, "work_dirs", "chip_smoke_eval")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    ann, mp, root = _eval_split(work)
    cfg = stage2()
    say(f"[eval] split: tools/make_synthetic_val.py --routes {EVAL_ROUTES} --frames-per-route "
        f"{EVAL_FRAMES_PER_ROUTE}, seeded 1600x900 JPEGs for the {EVAL_FRAMES * 6} cameras of "
        f"the first {EVAL_FRAMES} frames, in {time.perf_counter() - t0:.1f} s; checkpoint "
        f"{os.path.relpath(ckpt, ROOT)} step {checkpoint.latest_step(ckpt)}")
    dataset = eval_cli.open_dataset(cfg, ann, mp, root, test_mode=True)
    model = HiPAD(cfg, device=DEVICE)
    if checkpoint.load_params_only(ckpt, model):
        fail("eval: the checkpoint of the training CLI did not load whole")

    # fp32 through the runner: streaming, its frame 0 against a direct
    # forward, then batched against streaming
    n_deform, per_call = _launch_plan(cfg)
    tasks = dict(eval_det=True, eval_map=True, eval_motion=True)
    t = time.perf_counter()
    fp32 = runner.collect_records(model, dataset, EVAL_FRAMES, torch.float32, **tasks)
    fp32_s = time.perf_counter() - t
    frame = dataset[{"idx": 0, "aug_config": None}]
    images = torch.as_tensor(frame["images"][None], device=DEVICE)
    metas = {k: torch.as_tensor(np.asarray(frame[k])[None], device=DEVICE) for k in META_KEYS}
    with torch.no_grad():
        outputs, _ = model(images, metas)
    direct = runner._Collector(True, True, True, True)
    direct.collect(0, frame, postprocess.post_process(cfg, outputs, metas["gt_ego_fut_cmd"])[0])
    unequal = []
    for key, entries in direct.acc.items():
        mine = dict(fp32[key]).get(0)
        for name, ref in _entries(entries[0][1]).items() if entries else ():
            got = np.asarray(_entries(mine)[name]) if mine is not None else None
            if got is None or got.shape != ref.shape or not np.array_equal(got, ref):
                unequal.append(f"{key}.{name}")
    say(f"[eval] fp32 runner, {len(fp32['frames'])} frames streaming in {fp32_s:.1f} s: frame "
        f"0's records ({', '.join(f'{k} {len(v)}' for k, v in direct.acc.items() if v)}) against "
        f"a direct HiPAD.forward + post_process of the same frame: "
        f"{'equal bit for bit' if not unequal else 'UNEQUAL ' + ', '.join(unequal)}")
    if unequal:
        fail(f"eval: the runner's frame 0 differs from a direct forward in {unequal}")
    t = time.perf_counter()
    fp32_b = runner.collect_records(model, dataset, EVAL_FRAMES, torch.float32, batch_slots=2,
                                    num_workers=2, **tasks)
    fp32_bs = time.perf_counter() - t
    worst, moved, bad = _records_close(fp32_b, fp32)
    fs, fb = (_flat_summary(runner.summarize(x)) for x in (fp32, fp32_b))
    if set(fs) != set(fb):
        fail(f"eval: batched summary keys differ: {set(fs) ^ set(fb)}")
    for k in fs:
        tol = EVAL_REL * abs(fs[k]) + EVAL_ABS
        worst[f"summary {k}"] = abs(fb[k] - fs[k]) / tol
        if not abs(fb[k] - fs[k]) <= tol:
            bad.append(f"summary {k} {fb[k]:.6g} against {fs[k]:.6g}")
    rec = max((v, k) for k, v in worst.items() if not k.startswith("summary"))
    summ = max((v, k) for k, v in worst.items() if k.startswith("summary"))
    say(f"[eval] fp32 runner, batch_slots=2 num_workers=2, {len(fp32_b['frames'])} frames in "
        f"{fp32_bs:.1f} s, against streaming: records, largest error / tolerance {rec[0]:.3f} "
        f"({rec[1]}); summary {summ[0]:.3f} ({summ[1]}) (rel {EVAL_REL:g}, abs {EVAL_ABS:g}); "
        f"{len(moved)} runs of near-tied scores in another order, "
        f"{sum(m[5] for m in moved)} rows exchanged at a list's end")
    for key, idx, first, rows, gap, took in moved:
        say(f"[eval] fp32 batched against streaming: {key} frame {idx}, rows {first}-"
            f"{first + rows - 1} in another order (largest score gap {gap:.1e}, "
            f"{took} exchanged at the end)")
    if bad:
        fail(f"eval: batched differs from streaming in fp32: {bad[:6]}")
    del model
    torch.cuda.empty_cache()

    common = ["--ann-file", ann, "--map-file", mp, "--data-root", root, "--ckpt", ckpt,
              "--max-frames", str(EVAL_FRAMES), "--gather-dir", f"{work}/gather", *EVAL_TASKS]

    def cli(*extra, rank=None, echo=False):
        """The CLI's main (its lines before the tables printed when
        ``echo``) -> (its result, the launches it made)."""
        env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
        if rank is not None:
            os.environ.update(RANK=str(rank), WORLD_SIZE="2")
        out = io.StringIO()
        try:
            _reset_counts()
            with contextlib.redirect_stdout(out):
                res = eval_cli.main(common + list(extra))
            if echo:
                for line in out.getvalue().splitlines():
                    if line.startswith(("cameras:", "motion:")):
                        say(f"[eval] the CLI's report: {line}")
            return res, _kernel_counts()
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    stream, launches = cli(echo=True)
    perf = stream["perf"]
    if stream["cameras"]["absent"] or perf["frames"] != EVAL_FRAMES:
        fail(f"eval: cameras {stream['cameras']}, {perf['frames']} frames evaluated")
    for name in ("coarse_sample", "patch_sample"):
        want = EVAL_FRAMES * n_deform * per_call[name]
        say(f"[eval] streaming {name}: {launches[name]} launches over {perf['frames']} frames "
            f"= {launches[name] / perf['frames']:g}/frame (expected {n_deform} deformable "
            f"calls x {per_call[name]})")
        if launches[name] != want:
            fail(f"eval: {name} launched {launches[name]} times, expected {want}")
    batched, blaunch = cli("--batch-slots", "2", "--num-workers", "2")
    bperf = batched["perf"]
    forwards = blaunch["coarse_sample"] / (n_deform * per_call["coarse_sample"])
    for what, p in (("streaming", perf), ("--batch-slots 2 --num-workers 2", bperf)):
        say(f"[eval] python -m hipad_torch.tools.test {what} (stage 2, bf16) on {card}: "
            f"{p['frames']} frames in {p['wall_s']:.3f} s, fps_wall {p['fps_wall']:.3f}; "
            f"loader {p['load_s']:.3f} s = {p['load_share']:.3f} of the wall, forwards with "
            f"decode {p['forward_s']:.3f} s = {p['forward_share']:.3f} (host clock)")
    say(f"[eval] batched: {forwards:g} forwards for {bperf['frames']} frames (first frames at "
        f"bs=1, the rest at bs=2); K1 {blaunch['coarse_sample']}, K2 "
        f"{blaunch['patch_sample']} launches")
    if forwards != int(forwards) or not EVAL_FRAMES / 2 <= forwards < EVAL_FRAMES:
        fail(f"eval: the batched run made {forwards} forwards' launches")

    # two ranks, one after the other, through one gather dir
    fs = _flat_summary(stream["summary"])
    r1, _ = cli(rank=1)
    r0, _ = cli(rank=0)
    if r1["summary"] is not None or r0["summary"] is None:
        fail("eval: rank 1 returned a summary or rank 0 none")
    fm = _flat_summary(r0["summary"])
    if set(fm) != set(fs):
        fail(f"eval: merged summary keys differ: {set(fm) ^ set(fs)}")
    rworst = max((abs(fm[k] - fs[k]) / (RANKS_REL * abs(fs[k]) + RANKS_ABS), k) for k in fs)
    say(f"[eval] two ranks ({len(r1['records']['frames'])} + "
        f"{len(r0['records']['frames']) - len(r1['records']['frames'])} frames) merged on "
        f"rank 0 against one rank (bf16): largest error / tolerance {rworst[0]:.3f} "
        f"({rworst[1]}) (rel {RANKS_REL:g}, abs {RANKS_ABS:g})")
    if rworst[0] > 1:
        fail("eval: the two-rank summary differs from the single-rank one")
    s = stream["summary"]
    car = {k: v for k, v in s.get("motion", {}).items() if k.startswith("car")}
    say(f"[eval] summary (bf16; random weights after 4 synthetic steps): planning L2 avg "
        f"{s['planning'].get('plan_L2_avg', float('nan')):.4f} m over "
        f"{sum(1 for _, r in stream['records']['planning'] if r['fut_valid_flag'])} scored "
        f"frames, det mAP {s['detection']['mAP']:.4f}, map mAP {s['map']['mAP']:.4f}, motion "
        f"{car}")

    # training on the split's loader, with one eval
    _reset_counts()
    t = time.perf_counter()
    res = train.main(["--ann-file", ann, "--map-file", mp, "--data-root", root,
                      "--val-ann-file", ann, "--eval-interval", str(LOADER_STEPS),
                      "--eval-frames", str(LOADER_EVAL_FRAMES), "--max-iters", str(LOADER_STEPS),
                      "--batch-size", "1", "--log-interval", "1", "--seed", str(SEED),
                      "--work-dir", f"{work}/train"])
    loader_launches = _kernel_counts()
    bad = [k for m in res["metrics"] for k, v in m.items() if not math.isfinite(v)]
    if bad or len(res["metrics"]) != LOADER_STEPS or len(res["evals"]) != 1:
        fail(f"eval: loader training: non-finite {bad}, {len(res['metrics'])} steps, "
             f"{len(res['evals'])} evals")
    frames = LOADER_STEPS + LOADER_EVAL_FRAMES  # forwards: one per step, one per eval frame
    for name, per in _launch_plan(cfg)[1].items():
        want = (frames if "_bwd" not in name else LOADER_STEPS) * n_deform * per
        if loader_launches[name] != want:
            fail(f"eval: loader training launched {name} {loader_launches[name]} times, "
                 f"expected {want}")
    say(f"[eval] python -m hipad_torch.tools.train --ann-file <split> --eval-interval "
        f"{LOADER_STEPS} (stage 2, bf16, batch 1): {LOADER_STEPS} steps in "
        f"{time.perf_counter() - t:.1f} s, step ms {[round(x, 1) for x in res['step_ms']]}, "
        f"total_loss {[round(m['total_loss'], 4) for m in res['metrics']]} (no depth loss: no "
        f"LiDAR files); launches {loader_launches} (2 steps + {LOADER_EVAL_FRAMES} fp32 eval "
        f"frames); eval planning L2 avg "
        f"{res['evals'][0].get('planning', {}).get('plan_L2_avg', float('nan')):.4f}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, loader_launches


def phase_stage1(card: str):
    """One stage-1 training step (``stage1()``: no motion task, one plan
    anchor type) at full width, bs=1, fp32, on the card. -> launches."""
    import torch

    from hipad_torch.configs.model import stage1
    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage1()
    model = init_random(HiPAD(cfg, device=dev), SEED)
    step = make_train_step(cfg, model, AdamW(model.named_parameters()))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic.make_batch(cfg, 1, seed=SEED).items()}
    _reset_counts()
    t0 = time.perf_counter()
    _, metrics = step(None, batch, torch.Generator(device=dev).manual_seed(SEED))
    m = {k: float(v) for k, v in metrics.items()}
    ms = (time.perf_counter() - t0) * 1e3
    launches = _kernel_counts()
    bad = [k for k, v in m.items() if not math.isfinite(v)]
    if bad or any(k.startswith("motion") for k in m):
        fail(f"stage1: non-finite {bad} or a motion loss in {sorted(m)}")
    n_deform, per_call = _launch_plan(cfg)
    say(f"[stage1] stage1() step bs=1 fp32 on {card}: {ms:.1f} ms (first step), "
        f"{len(cfg.plan_anchor_types)} plan anchor type, tasks {cfg.task_select}, every loss "
        f"finite, total_loss {m['total_loss']:.4f} grad_norm {m['grad_norm']:.4f}; launches "
        + ", ".join(f"{k} {launches[k]} (expected {n_deform * v})" for k, v in per_call.items()))
    for name, per in per_call.items():
        if launches[name] != n_deform * per or per == 0:
            fail(f"stage1: {name} launched {launches[name]} times, expected {n_deform * per}")
    del model, step
    torch.cuda.empty_cache()
    return launches


# two ranks at bs=1 against one process at bs=2: rtol of
# tests/test_sharding_equivalence.py
DDP_RTOL = 1e-2
DDP_TIMEOUT_S = 600
_DDP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[5])
import torch
from hipad_torch.configs.model import stage2
from hipad_torch.models.deformable import DeformableAggregation
from hipad_torch.models.detector import HiPAD
from hipad_torch.ops import kernels
from hipad_torch.parallel import mesh
from hipad_torch.train.optim import AdamW
from hipad_torch.train.train_step import make_train_step
rank, port, job, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dp = mesh.init("gloo", f"tcp://localhost:{port}", 2, rank)
cfg = stage2(drop_out=0.0, use_grid_mask=False)
payload = torch.load(job, weights_only=True)
model = HiPAD(cfg, device="cuda", group=dp.group)
model.load_state_dict(payload["state_dict"])
for m in model.modules():
    if isinstance(m, DeformableAggregation):
        m.attn_drop = 0.0
batch = {k: v.cuda() for k, v in mesh.local_batch(payload["batch"], rank, 2).items()}
step = make_train_step(cfg, model, AdamW(model.named_parameters()), group=dp.group)
_, metrics = step(None, batch, torch.Generator(device="cuda").manual_seed(0))
torch.save({k: v.cpu() for k, v in model.state_dict().items()}, f"{out}.pt")
with open(f"{out}.json", "w") as f:
    json.dump({"metrics": {k: float(v) for k, v in metrics.items()},
               "launches": {k.name: k.launches for k in kernels.KERNELS}}, f)
mesh.shutdown(dp)
"""


def phase_ddp(card: str):
    """Data parallelism on the one card: two processes over gloo, each a
    stage-2 step at bs=1 on its half of a global batch of 2 (drop_out 0, no
    GridMask, fp32), against one process at bs=2 on the whole batch from the
    same weights. -> the two ranks' launches, summed."""
    import socket

    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.data import synthetic
    from hipad_torch.models.deformable import DeformableAggregation
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2(drop_out=0.0, use_grid_mask=False)
    work = os.path.join(ROOT, "work_dirs", "chip_smoke_ddp")
    os.makedirs(work, exist_ok=True)
    model = init_random(HiPAD(cfg, device=dev), SEED)
    for m in model.modules():
        if isinstance(m, DeformableAggregation):
            m.attn_drop = 0.0
    batch = {k: torch.as_tensor(v) for k, v in synthetic.make_batch(cfg, 2, seed=SEED).items()}
    job = os.path.join(work, "job.pt")
    torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "batch": batch}, job)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONHASHSEED="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _DDP_CHILD, str(r), port, job,
                               os.path.join(work, f"rank{r}"), ROOT], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    # meanwhile the one process at bs=2
    _, metrics = make_train_step(cfg, model, AdamW(model.named_parameters()))(
        None, {k: v.to(dev) for k, v in batch.items()}, torch.Generator(device=dev).manual_seed(0))
    single = {k: float(v) for k, v in metrics.items()}
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DDP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"ddp: rank {r} exited with {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    say(f"[ddp] 2 processes x bs=1 over gloo on one {card} against 1 process x bs=2 (stage 2, "
        f"fp32, drop_out 0, no GridMask): {time.perf_counter() - t0:.1f} s")
    for k in sorted(single):
        vals = [r["metrics"][k] for r in ranks]
        err = max(abs(v - single[k]) for v in vals)
        tol = DDP_RTOL * abs(single[k])
        say(f"[ddp] step 0 {k}: ranks {vals[0]:.6f} {vals[1]:.6f}, one process "
            f"{single[k]:.6f}, abs_err {err:.3e} (tol {tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"ddp: {k} of the two ranks disagrees with the one process on the global batch")
    sd = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True) for r in range(2)]
    differ = [k for k in sd[0] if not torch.equal(sd[0][k], sd[1][k])]
    say(f"[ddp] parameters and buffers after the update: {len(sd[0]) - len(differ)} of "
        f"{len(sd[0])} tensors equal bit for bit on both ranks")
    if differ:
        fail(f"ddp: the ranks' parameters differ after the update: {differ[:5]}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    n_deform, per_call = _launch_plan(cfg)
    for name, per in per_call.items():
        if launches[name] != 2 * n_deform * per:
            fail(f"ddp: {name} launched {launches[name]} times by the two ranks, expected "
                 f"{2 * n_deform * per}")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    return launches


class _Selections:
    """Every ranking a forward and its post-processing make, all through
    ``hipad_torch.ops.ranking.topk``: the keypoint top-k, the first frame's
    confidence sort, the banks' top-k and the decode's top-k.

    On the card it records each call's picks. On the CPU, given the card's
    record, it checks each call's own picks against the card's (where they
    differ: the gap between the two picked items' CPU scores, which may not
    exceed E2E_RTOL x the largest score + E2E_ATOL) and then takes the
    card's picks, so that both runs go on with the same selections and
    their outputs can be held key by key. ``stage`` ("forward" or "decode")
    is set by the caller. With ``hold=False`` a gap above the tolerance is
    printed, not failed (``worst`` keeps the largest gap)."""

    def __init__(self, card_calls=None, tag="[serve]", hold=True):
        self.card_calls, self.calls, self.differ, self.stage = card_calls, [], 0, "forward"
        self.tag, self.hold, self.worst = tag, hold, 0.0

    def _pick(self, scores, k):
        """-> the indices this run goes on with (the card's, on the CPU)."""
        i = len(self.calls)
        mine = self._topk(scores, k)[1]
        what = (self.stage, tuple(scores.shape), k)
        self.calls.append((what, mine.cpu()))
        if self.card_calls is None:
            return mine
        if i >= len(self.card_calls) or self.card_calls[i][0] != what:
            fail(f"selection {i}: the CPU ranked {what} where the card ranked "
                 f"{self.card_calls[i][0] if i < len(self.card_calls) else 'nothing'}")
        card = self.card_calls[i][1]
        same = card == mine
        if not same.all():
            gap = (scores.gather(-1, card) - scores.gather(-1, mine)).detach().abs()
            tol = E2E_RTOL * float(scores.detach().abs().max()) + E2E_ATOL
            where = (~same).nonzero()
            self.differ += len(where)
            worst = float(gap[~same].max())
            self.worst = max(self.worst, worst)
            shown = ", ".join(
                f"rank {tuple(w.tolist())}: card {int(card[tuple(w)])} cpu "
                f"{int(mine[tuple(w)])} gap {float(gap[tuple(w)]):.3e}" for w in where[:4])
            say(f"{self.tag} selection {i} ({self.stage}, top-{k} of {tuple(scores.shape)}): "
                f"{len(where)} ranks differ, largest gap {worst:.3e} (tol {tol:.3e}); {shown}; "
                f"the CPU goes on with the card's picks")
            if worst > tol and self.hold:
                fail(f"selection {i}: card and CPU picks differ by more than the tolerance")
        return card

    def __enter__(self):
        from hipad_torch.ops import ranking

        self._ranking, self._topk = ranking, ranking.topk

        def topk(x, k):
            idx = self._pick(x, k)
            return x.gather(-1, idx), idx

        ranking.topk = topk
        return self

    def __exit__(self, *exc):
        self._ranking.topk = self._topk


def _frame0_against_cpu(tag: str, cfg, model, img, mt):
    """Frame 0 of ``model`` (on the card) post-processed, then the same frame
    on a CPU copy of it (the plain path) with every selection recorded: a
    pick that differs is printed with its score gap and fails above
    E2E_RTOL x the largest score + E2E_ATOL, and the CPU goes on with the
    card's picks; then every post-processed output key by key (the plan's
    only where both pick the same mode)."""
    import torch

    from hipad_torch import postprocess
    from hipad_torch.models.detector import HiPAD

    cpu_model = HiPAD(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    decoded, card_calls = [], None
    t0 = time.perf_counter()
    for m, d in ((model, img.device), (cpu_model, torch.device("cpu"))):
        i, t = img.to(d), {k: v.to(d) for k, v in mt.items()}
        with torch.no_grad(), _Selections(card_calls, tag) as sel:
            out, _ = m(i, t)
            sel.stage = "decode"
            dec = postprocess.post_process_arrays(cfg, out, t["gt_ego_fut_cmd"])
        per = cfg.ego_fut_cmd * cfg.ego_fut_mode
        ri = cfg.plan_anchor_types.index(cfg.plan_anchor_refer)
        dec["refer_cls"] = out["plan"]["classification"][-1][:, 0, per * ri:per * (ri + 1)]
        decoded.append({k: v.cpu() for k, v in dec.items()})
        card_calls = sel.calls
    say(f"{tag} frame 0 on the card, then on the CPU with the card's picks: "
        f"{time.perf_counter() - t0:.1f} s, {len(card_calls)} selections, {sel.differ} "
        f"ranks of them picked differently by the CPU (each within tolerance)")
    got, ref = decoded
    same_mode = int(got["plan_mode_idx"][0]) == int(ref["plan_mode_idx"][0])
    if not same_mode:
        c = ref["refer_cls"][0]
        gap = abs(float(c[got["plan_mode_idx"][0]] - c[ref["plan_mode_idx"][0]]))
        tol = E2E_RTOL * float(c.abs().max()) + E2E_ATOL
        say(f"{tag} plan mode: card {int(got['plan_mode_idx'][0])} cpu "
            f"{int(ref['plan_mode_idx'][0])} gap {gap:.3e} (tol {tol:.3e}); the plan "
            f"waypoints are not compared")
        if gap > tol:
            fail(f"{tag} plan mode selection differs by more than the tolerance")
    for key in sorted(k for k in ref if k != "refer_cls"):
        if key.startswith("plan_") and not same_mode:
            continue
        r, g = ref[key], got[key]
        if not r.is_floating_point():
            ok = torch.equal(r, g)
            say(f"{tag} card vs CPU {key} {tuple(r.shape)}: {'equal' if ok else 'DIFFERENT'}")
        else:
            err = float((g.double() - r.double()).abs().max())
            tol = E2E_RTOL * float(r.abs().max()) + E2E_ATOL
            ok = err <= tol
            say(f"{tag} card vs CPU {key} {tuple(r.shape)}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag} card and CPU disagree on {key}")


# [graphs]: a cold frame, then warm frames, each graphed and through the
# decoder's own eager op loop; then frames timed in turns and the spans
GRAPH_WARM_FRAMES = 8
GRAPH_TIMED_FRAMES = 10
# the benchmark's stage2.frame: 24 at the sampler's fine-level weights, 21 in
# to_result_dicts, 14 in the plan decode, 1 in the bank
GRAPH_FRAME_SYNCS = 60


def _named_leaves(tree):
    """(path, tensor) of a forward's (outputs, banks), in a fixed order."""
    import dataclasses

    out, banks = tree
    return list(_flat(out, "out.")) + [
        (f"banks.{n}.{f.name}", getattr(getattr(banks, n), f.name))
        for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))]


def _leaf_diffs(a, b):
    """[(path, max |a - b|, max |b|)] of the leaves not equal bit for bit."""
    import torch

    rows = []
    for (path, x), (_, y) in zip(_named_leaves(a), _named_leaves(b)):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            d = (x.double() - y.double()).abs().max() if x.shape == y.shape else float("inf")
            rows.append((path, float(d), float(y.double().abs().max())))
    return rows


def phase_graphs(card: str):
    """``stage2()`` and ``stage2_serving_det()`` at bs=1, bf16 and fp32: a
    cold frame and 8 warm frames, each through ``HiPAD``'s decoder (the op
    runs replayed as CUDA graphs from the third frame on) and, from the same
    feature maps and banks, through its ``forward_eager`` (every op eager,
    one at a time): outputs and banks equal bit for bit; the graph counter
    a frame (7 eager, 7 eager, 7 captured, then 7 replayed); every frame's
    outputs and banks, held, unchanged after the later frames. Then, bf16:
    one warm frame with post-processing under the sync debug mode (60 waits
    at ``stage2``), frames in turns graphed / eager on the host clock, one
    of each profiled (host launch calls, device kernels, device busy), and
    the graphed frames' host ms by span."""
    import torch

    from hipad_torch import postprocess
    from hipad_torch.configs.model import stage2, stage2_serving_det
    from hipad_torch.data import synthetic
    from hipad_torch.models.common import to_float32
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.utils import spans
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    for make in (stage2, stage2_serving_det):
        cfg, name = make(), make.__name__
        t0 = time.perf_counter()
        model = init_random(HiPAD(cfg, device=dev), SEED)
        dec = model.decoder
        n_runs = sum(cfg.operation_order[lo] != "deformable" for lo, _ in dec.units)
        images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)

        def inputs(i):
            return images + 1e-3 * i, dict(metas, timestamp=metas["timestamp"] + 0.5 * i)

        def amp(dtype):
            return torch.autocast("cuda", dtype=dtype, enabled=dtype != torch.float32)

        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            banks, held, differ = None, [], []
            for i in range(1 + GRAPH_WARM_FRAMES):
                img, mt = inputs(i)
                with torch.no_grad(), amp(dtype):
                    fmaps = model.backbone(img)
                    want = dec.forward_eager(fmaps, mt, banks)
                    before = dict(dec.graphs.counts)
                    got = dec(fmaps, mt, banks)
                delta = {k: v - before[k] for k, v in dec.graphs.counts.items() if v > before[k]}
                expect = {"eager": n_runs} if i < 2 else {
                    "captured" if i == 2 else "replayed": n_runs}
                if delta != expect:
                    fail(f"[graphs] {name} {dt} frame {i}: runs {delta}, expected {expect}")
                rows = _leaf_diffs(got, want)
                differ += [(i, *r) for r in rows]
                held.append((got, [(p, x.clone()) for p, x in _named_leaves(got)]))
                banks = got[1]
            torch.cuda.synchronize()
            for i, (live, snap) in enumerate(held):
                changed = [p for (p, x), (_, y) in zip(_named_leaves(live), snap)
                           if not torch.equal(x, y)]
                if changed:
                    fail(f"[graphs] {name} {dt} frame {i}'s {changed[:4]} changed after the "
                         f"later frames: a graph's buffer was handed out")
            say(f"[graphs] {name} {dt} on {card}: 1 cold + {GRAPH_WARM_FRAMES} warm frames, "
                f"{n_runs} runs a frame (eager, eager, captured, then replayed), graphed vs "
                f"forward_eager: "
                + ("outputs and banks equal bit for bit" if not differ else
                   f"{len(differ)} leaves differ: " + "; ".join(
                       f"frame {i} {p} max_abs {d:.3e} of max {m:.3e}"
                       for i, p, d, m in differ[:12]))
                + f"; every frame's outputs and banks unchanged after the later frames")
            for i, p, d, m in differ:
                if d > E2E_RTOL * m + E2E_ATOL:
                    fail(f"[graphs] {name} {dt} frame {i} {p}: graphed and eager differ by "
                         f"{d:.3e} (tol {E2E_RTOL * m + E2E_ATOL:.3e})")
        say(f"[graphs] {name}: built and checked in {time.perf_counter() - t0:.1f} s; "
            f"counts {dec.graphs.counts}")

        # bf16, as the benchmark's frame runs: waits, host clock, launches, spans
        state = {"banks": banks, "i": 1 + GRAPH_WARM_FRAMES}

        def frame(eager=False):
            img, mt = inputs(state["i"])
            with torch.no_grad():
                with amp(torch.bfloat16):
                    if eager:
                        with spans.span("forward"):
                            fmaps = model.backbone(img)
                            with spans.span("decoder"):
                                out, new = dec.forward_eager(fmaps, mt, state["banks"])
                    else:
                        out, new = model(img, mt, state["banks"])
                d = postprocess.post_process_arrays(cfg, to_float32(out), mt["gt_ego_fut_cmd"])
            postprocess.to_result_dicts(d)
            state["i"] += 1
            state["banks"] = new

        for _ in range(2):  # the bf16 graphs of this key: first sight, capture
            frame()
        torch.cuda.synchronize()
        before = dict(dec.graphs.counts)
        sites = _sync_sites(frame)
        total = sum(sites.values())
        say(f"[syncs] [graphs] {name} one warm bf16 frame with post-processing: {total} "
            f"synchronizing calls at {len(sites)} call sites (runs {dict(dec.graphs.counts)} "
            f"after, {before} before):")
        for site, n in sites.most_common():
            say(f"[syncs]   {n:5d}  {site}")
        if name == "stage2" and total != GRAPH_FRAME_SYNCS:
            fail(f"[graphs] {name}: {total} waits a frame, expected {GRAPH_FRAME_SYNCS}")
        if any("decoder" in s or "encoders.py" in s or "refine.py" in s for s in sites):
            fail(f"[graphs] {name}: a wait inside the decoder's runs")
        ms = {"graphed": [], "eager": []}
        for r in range(GRAPH_TIMED_FRAMES):
            for kind in (("graphed", "eager") if r % 2 == 0 else ("eager", "graphed")):
                torch.cuda.synchronize()
                t = time.perf_counter()
                frame(eager=kind == "eager")
                ms[kind].append((time.perf_counter() - t) * 1e3)
        say(f"[graphs] {name} bf16 frames with post-processing in turns on {card} (host "
            f"clock, sync around each, {GRAPH_TIMED_FRAMES} each): graphed median "
            f"{statistics.median(ms['graphed']):.2f} ms [{min(ms['graphed']):.2f}, "
            f"{max(ms['graphed']):.2f}], eager {statistics.median(ms['eager']):.2f} ms "
            f"[{min(ms['eager']):.2f}, {max(ms['eager']):.2f}]")
        for kind in ("graphed", "eager"):
            host = []
            ks, busy = _profiled(lambda: frame(eager=kind == "eager"), host=host)
            host = host[0]
            say(f"[graphs] {name} one {kind} frame profiled: {host} host launch calls "
                f"(kernels, graphs, copies, fills), {ks} device kernels, device busy "
                f"{busy:.2f} ms")
        for kind in ("graphed", "eager"):
            with spans.recording() as rec:
                for _ in range(GRAPH_TIMED_FRAMES):
                    with rec.unit():
                        frame(eager=kind == "eager")
            summ = rec.summary()
            top = sorted(((n, s) for n, s in summ.items()
                          if n in ("forward", "backbone", "postprocess", "to_host")
                          or n.startswith("decoder")), key=lambda x: -x[1]["incl_ms"])
            say(f"[graphs] {name} {kind} bf16 frames under spans.recording() (median of "
                f"{GRAPH_TIMED_FRAMES}; wall {statistics.median(rec.unit_walls_ms()):.2f} ms): "
                + ", ".join(f"{n} {s['incl_ms']:.2f} ms ({s['calls']:.0f})" for n, s in top))
        del model, dec
        torch.cuda.empty_cache()


# stage2_serving_det frames timed in turns with stage2 frames (informational)
SERVE_ROUNDS = 3


def phase_serving(card: str):
    """``stage2_serving_det()`` bs=1: chained frames with post-processing in
    fp32 and bf16 autocast, K1/K2 launches against the op program; frame 0
    post-processed on the card and on the CPU, selection by selection and key
    by key; then stage2 and serving frames in turns. -> (fp32 launches,
    the serving model's weights)."""
    import torch

    from hipad_torch import postprocess
    from hipad_torch.configs.model import stage2, stage2_serving_det
    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.ops import kernels
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2_serving_det()
    t0 = time.perf_counter()
    model = init_random(HiPAD(cfg, device=dev), SEED)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)
    say(f"[serve] stage2_serving_det (sampler_point_frac {cfg.sampler_point_frac}, "
        f"topk_det_list {cfg.topk_det_list}) built with seeded weights in "
        f"{time.perf_counter() - t0:.1f} s")
    n_deform, per_call = _launch_plan(cfg)
    per_call = {k: v for k, v in per_call.items() if not k.endswith("_bwd")}
    n_frames = WARMUP_FRAMES + TIMED_FRAMES

    def frame_inputs(i):
        return images + 1e-3 * i, dict(metas, timestamp=metas["timestamp"] + 0.5 * i)

    def frame(m, dtype, i, banks, decode=True):
        img, mt = frame_inputs(i)
        with torch.no_grad(), torch.autocast("cuda", dtype=dtype,
                                             enabled=dtype != torch.float32):
            out, banks = m(img, mt, banks)
            dec = postprocess.post_process_arrays(
                cfg, out, mt["gt_ego_fut_cmd"]) if decode else None
        return dec, banks

    launches = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for k in kernels.KERNELS:
            k.launches = 0
        banks, times = None, []
        for i in range(n_frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dec, banks = frame(model, dtype, i, banks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            bad = [k for k, v in dec.items() if v.is_floating_point() and not torch.isfinite(v).all()]
            if bad:
                fail(f"serving {name} frame {i}: non-finite post-processed outputs {bad[:5]}")
        timed = sorted(times[WARMUP_FRAMES:])
        say(f"[serve] stage2_serving_det bs=1 {name} on {card}: {n_frames} chained frames with "
            f"post_process_arrays, every output finite; per frame median "
            f"{statistics.median(timed):.2f} ms, min {timed[0]:.2f}, max {timed[-1]:.2f} "
            f"(host clock, sync per frame, frames {WARMUP_FRAMES}..{n_frames - 1}); "
            f"frame 0 {times[0]:.1f} ms")
        counts = {k.name: k.launches for k in kernels.KERNELS}
        for kname, per in per_call.items():
            want = n_frames * n_deform * per
            say(f"[serve] {name} {kname}: {counts[kname]} launches over {n_frames} frames "
                f"(expected {n_deform} deformable calls x {per} = {n_deform * per}/frame)")
            if counts[kname] != want or want == 0:
                fail(f"serving: {kname} launched {counts[kname]} times, expected {want}")
        launches = launches or counts

    # under torch's deterministic flag: frame 0 from cold banks and frame 1
    # from frame 0's, each twice, bit for bit (forward only: K1 and K2 write
    # each output once)
    with flag(True):
        for dtype, n in ((torch.float32, 2), (torch.bfloat16, 1)):
            banks0 = None
            for i in range(n):
                runs = [frame(model, dtype, i, banks0) for _ in range(2)]
                (dec_a, banks_a), (dec_b, banks_b) = runs
                keys = sorted(dec_a)
                if not (_bits_equal(tuple(dec_a[k] for k in keys), tuple(dec_b[k] for k in keys))
                        and _bits_equal(tuple(_tensors_of_banks(banks_a)),
                                        tuple(_tensors_of_banks(banks_b)))):
                    fail(f"[serve] {str(dtype)[6:]} frame {i} under the deterministic flag "
                         f"differs between two runs from the same banks")
                banks0 = banks_a
            say(f"[serve] {str(dtype)[6:]} frame 0 (cold){' and 1 (on its banks)' if n > 1 else ''}"
                f" under torch.use_deterministic_algorithms(True), each twice from the same "
                f"banks: post-processed outputs ({len(keys)} arrays) and banks equal bit for bit")
        del runs, banks0

    # frame 0 on the card, then on the CPU plain path with the card's picks
    _frame0_against_cpu("[serve]", cfg, model, *frame_inputs(0))

    # stage2 and serving frames in turns (informational)
    base = init_random(HiPAD(stage2(), device=dev), SEED)
    runs = {"stage2": [base, None, []], "stage2_serving_det": [model, None, []]}
    for i in range(WARMUP_FRAMES + SERVE_ROUNDS):
        for r in runs.values():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, r[1] = frame(r[0], torch.float32, i, r[1], decode=False)
            torch.cuda.synchronize()
            r[2].append((time.perf_counter() - t) * 1e3)
    a, b = (r[2][WARMUP_FRAMES:] for r in runs.values())
    diff = [y - x for x, y in zip(a, b)]
    say(f"[serve] stage2 and stage2_serving_det fp32 frames in turns, {SERVE_ROUNDS} rounds "
        f"after {WARMUP_FRAMES} (host clock, sync per frame; the serving frame without "
        f"post-processing here): stage2 median {statistics.median(a):.2f} ms "
        f"[{min(a):.2f}, {max(a):.2f}], serving {statistics.median(b):.2f} ms "
        f"[{min(b):.2f}, {max(b):.2f}], serving - stage2 per round median "
        f"{statistics.median(diff):.2f} ms [{min(diff):.2f}, {max(diff):.2f}] (informational)")
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del base, runs, model
    torch.cuda.empty_cache()
    return launches, weights


# ---- [options]: the decoder's model options --------------------------------

# frame A: the serving config with the level top-k, both attention masks and
# the per-point embeds in the deformable weights heads; B: stage 2 with the
# concat point expansion (900 + 2000 + 2880 + 1 joint queries); C: stage 2
# with the oracle sampler, which the card runs through K1 and K2 with every
# camera kept
OPTIONS_A = dict(sampler_level_k=1, with_distance_attn_mask=True, with_velocity_attn_mask=True,
                 with_deform_map_points=True, with_deform_plan_points=True)
OPTIONS_B = dict(with_concat_map_points=True, with_concat_plan_points=True)
OPTIONS_C = dict(sampler="reference")
# decoder layers of the card-against-CPU frame 0 of B and C (the card's
# chained frames run all six): the CPU plain path's frames cost seconds a
# layer at full width
OPTIONS_CPU_LAYERS = 2


def _lk_inputs(cfg, g, dev, dtype, renorm):
    """K2-lk's inputs at phase 3's K2 shapes (the det task at stage 2, cam_k
    slots): the weights of both fine levels drawn as ``_k2_inputs`` draws
    them, then each sample's level of largest mass kept
    (``sampling._keep_top_levels``, renormalised or not) -> (maps, cam, x,
    y, kept weights ``[bs, M, 1, G]``, cam_k, lvl ``[bs, M, 1]``). Every 50th
    x on a pixel corner of level 0 and every 50th y (offset 25) on one of
    level 1: the hat weights' kinks."""
    from hipad_torch.ops import sampling

    maps, cam, x, y, w, cam_k = _k2_inputs(cfg, g, dev, dtype)
    W0, H1 = maps[0].shape[3], maps[1].shape[2]
    x[:, ::50] = ((x[:, ::50] * W0 - 0.5).round() + 0.5) / W0
    y[:, 25::50] = ((y[:, 25::50] * H1 - 0.5).round() + 0.5) / H1
    kept, lvl = sampling._keep_top_levels(w, 1, renorm)
    return maps, cam, x, y, kept.contiguous(), cam_k, lvl


def _lk_grid_sample(maps, x, y, lvl):
    """``F.grid_sample``'s inputs for the library row of K2-lk: on each fine
    map, the samples that keep it, spread over the cameras (not the same
    function: no slots, no weights, no sums)."""
    import torch

    bs, cams = x.shape[0], maps[0].shape[1]
    out = []
    for l, m in enumerate(maps):
        sel = (lvl[..., 0] == l).reshape(-1)
        xy = torch.stack([x.reshape(-1)[sel], y.reshape(-1)[sel]], -1)
        n = xy.shape[0] // (bs * cams) * (bs * cams)
        out.append((m.reshape(bs * cams, *m.shape[2:]).permute(0, 3, 1, 2),
                    xy[:n].reshape(bs * cams, 1, -1, 2) * 2 - 1))
    return out


def _options_kernels(cfg, card: str):
    """K2-lk and K2-bwd-lk at the det task's stage-2 shapes (M0 = 11,700,
    cam_k 2, level_k 1), renormalised and not, fp32 and bf16 maps, against
    the plain version and autograd of it; timed at fp32 with the
    renormalisation. -> their records."""
    import torch
    import torch.nn.functional as F

    from hipad_torch.ops import kernels, sampling

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    fwd, bwd = _Rec(), _Rec()
    for dtype in (torch.float32, torch.bfloat16):
        for renorm in (True, False):
            maps, cam, x, y, w, cam_k, lvl = _lk_inputs(cfg, g, dev, dtype, renorm)
            bs, M = x.shape
            C = maps[0].shape[-1]
            share = float((lvl == 0).float().mean())
            what = (f"{str(dtype)[6:]} renorm={'on' if renorm else 'off'} M={M} cam_k={cam_k} "
                    f"level_k={lvl.shape[-1]} (level 0 kept by {share:.2f} of the slots)")
            got = kernels.patch_sample_lk(maps, cam, x, y, w, cam_k, lvl)
            ref = sampling.patch_sample_plain(maps, cam, x, y, w, cam_k, lvl)
            torch.cuda.synchronize()
            err, scale = _max_err(got, ref)
            ok = err <= KERNEL_RTOL * scale
            say(f"[options] K2-lk patch_sample_lk {what}: max_abs_err {err:.3e} (tol "
                f"{KERNEL_RTOL:g} x {scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K2-lk disagrees with its plain version ({what})")
            fwd.err = max(fwd.err, err)
            if not renorm:
                continue
            gout = torch.randn(bs, M // cam_k, C, generator=g, device=dev)
            lm = [m.detach().clone().requires_grad_() for m in maps]
            lx, ly, lw = (t.detach().clone().requires_grad_() for t in (x, y, w))
            out = sampling.patch_sample_plain(lm, cam, lx, ly, lw, cam_k, lvl)
            ref_g = torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True)
            ref_g = (ref_g[:len(lm)],) + tuple(ref_g[len(lm):])
            args = (maps, cam, x, y, w, gout, cam_k, lvl)
            dmaps, dx, dy, dw = kernels.patch_sample_bwd_lk(*args)
            torch.cuda.synchronize()
            bwd.err = max(bwd.err, _bwd_repeats("[options]", f"K2-bwd-lk {what}",
                                                kernels.patch_sample_bwd_lk, args, ref_g,
                                                dtype == torch.bfloat16))
            if dtype != torch.float32:
                continue
            lib = _lk_grid_sample(maps, x, y, lvl)
            t = fwd.add_times(*_times([
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k, lvl),
                lambda: kernels.patch_sample_lk(maps, cam, x, y, w, cam_k, lvl),
                lambda: kernels.patch_sample_lk(maps, cam, x, y, w, cam_k, lvl),
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k, lvl),
                lambda: [F.grid_sample(m, gr, align_corners=False) for m, gr in lib]]))
            taps, map_bytes = _k2_reads(maps, cam, x, y, w, False, lvl)
            fwd.add_bound(bound(map_bytes + _nbytes(cam, x, y, w, lvl, got), taps * C * 2))
            say(f"[options] K2-lk fp32 on {card}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
                f"F.grid_sample (each kept level's samples, no slots or weights: not the same "
                f"function) {t[2]:.4f} ms ({TIMES}); per call {fwd.per_call_ms:.4f} ms; bound "
                f"{fwd.bound_ms:.4f} ms ({fwd.bound_by}: {taps} taps, {map_bytes / 1e6:.2f} of "
                f"{_nbytes(*maps) / 1e6:.2f} MB of maps read)")
            lib_in = [[m.detach().clone().requires_grad_(), gr.detach().clone().requires_grad_()]
                      for m, gr in lib]
            lib_out = [F.grid_sample(*a, align_corners=False) for a in lib_in]
            lib_g = [torch.randn_like(o) for o in lib_out]
            t = bwd.add_times(*_times([
                lambda: torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True),
                lambda: kernels.patch_sample_bwd_lk(maps, cam, x, y, w, gout, cam_k, lvl),
                lambda: kernels.patch_sample_bwd_lk(maps, cam, x, y, w, gout, cam_k, lvl),
                lambda: torch.autograd.grad(out, lm + [lx, ly, lw], gout, retain_graph=True),
                lambda: [torch.autograd.grad(o, a, go, retain_graph=True)
                         for o, a, go in zip(lib_out, lib_in, lib_g)]]))
            taps, map_bytes = _k2_reads(maps, cam, x, y, w, True, lvl)
            bwd.add_bound(bound(map_bytes + _nbytes(cam, x, y, w, lvl, gout, *dmaps, dx, dy, dw),
                                taps * C * 4))
            say(f"[options] K2-bwd-lk fp32 on {card}: kernel {t[0]:.4f} ms, plain backward "
                f"{t[1]:.4f} ms, F.grid_sample backward (not the same function) {t[2]:.4f} ms "
                f"({TIMES}); per call {bwd.per_call_ms:.4f} ms; bound {bwd.bound_ms:.4f} ms "
                f"({bwd.bound_by}: {taps} taps, {map_bytes / 1e6:.2f} MB of maps read)")
            del out, lm, ref_g
    return {"patch_sample_lk": fwd, "patch_sample_bwd_lk": bwd}


def _options_reference_route(card: str):
    """One det deformable op of ``stage2(sampler="reference")`` on the card
    (seeded weights, the config's det anchors, the synthetic rig, a random
    stage-2 pyramid), which runs K1 and K2 with every camera kept and no
    renormalisation, against the same op whose sampling is
    ``deformable_aggregation`` run plainly on the card, fp32."""
    import torch

    from hipad_torch.configs.model import stage2
    from hipad_torch.data import synthetic
    from hipad_torch.models.deformable import DeformableAggregation
    from hipad_torch.models.detector import batch_to_torch
    from hipad_torch.models.keypoints import BoxKeypoints
    from hipad_torch.ops import sampling
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2(**OPTIONS_C)
    C, H, W = cfg.embed_dims, *cfg.input_size
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.device(dev):
        kps = init_random(BoxKeypoints(cfg.det_kps, C), SEED)
        op = init_random(DeformableAggregation(
            C, cfg.num_groups, cfg.num_levels, cfg.num_cams, kps.num_pts, sampler=cfg.sampler,
            sampler_matmul_levels=cfg.sampler_matmul_levels), SEED).eval()
    _, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)
    anchor = torch.as_tensor(cfg.det_anchor, dtype=torch.float32, device=dev)[None]
    f, e = (torch.randn(1, anchor.shape[1], C, generator=g, device=dev) for _ in range(2))
    maps = [torch.randn(1, cfg.num_cams, H // s, W // s, C, generator=g, device=dev)
            for s in cfg.strides]
    args = (kps, f, anchor, e, maps, metas["projection_mat"], metas["image_wh"])
    with torch.no_grad():
        _reset_counts()
        got = op(*args)
        launches = _kernel_counts()
        pts2d, w = op.prepare(kps, f, anchor, e, metas["projection_mat"], metas["image_wh"])
        ref = op.finish(sampling.deformable_aggregation(maps, pts2d, w), f)
        torch.cuda.synchronize()
        inside = float(sampling._inside(pts2d).float().mean())
        err, scale = _max_err(got, ref)
        ok = err <= KERNEL_RTOL * scale
        say(f"[options] reference route: det op of stage2(sampler='reference'), "
            f"{anchor.shape[1]} anchors x {pts2d.shape[2]} keypoints x {cfg.num_cams} cameras "
            f"({inside:.3f} of them in an image), K1 {launches['coarse_sample']} and K2 "
            f"{launches['patch_sample']} launch(es), cam_k {cfg.num_cams}, no renorm, against "
            f"deformable_aggregation on the card: max_abs_err {err:.3e} (tol {KERNEL_RTOL:g} x "
            f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok or launches["coarse_sample"] != 1 or launches["patch_sample"] != 1:
            fail("the reference route disagrees with the oracle or did not run K1 and K2 once")
        # CUDA events around each call (the oracle's calls do not queue behind
        # a sleep kernel: a call waits for the host)
        ms = _timed([
            lambda: sampling.deformable_aggregation(maps, pts2d, w),
            lambda: sampling.deformable_aggregation_topk(
                maps, pts2d, w, cam_k=cfg.num_cams, matmul_levels=cfg.sampler_matmul_levels),
            lambda: sampling.deformable_aggregation_topk(
                maps, pts2d, w, cam_k=cfg.num_cams, matmul_levels=cfg.sampler_matmul_levels),
            lambda: sampling.deformable_aggregation(maps, pts2d, w)])
    say(f"[options] reference route fp32 on {card}: the sampling through K1 and K2 "
        f"{min(ms[1:3]):.4f} ms a call, the oracle plainly {min(ms[0], ms[3]):.4f} ms (CUDA "
        f"events around each of 20 calls, median, in turns; informational)")
    del op, maps
    torch.cuda.empty_cache()


def _options_frames(tag: str, cfg, cpu_cfg, card: str):
    """``cfg`` bs=1 with seeded weights: 2 warm-up and 8 chained frames in
    fp32 then bf16 autocast, every output finite, each sampler kernel's
    launches against the op program; then frame 0 of ``cpu_cfg`` (``cfg``,
    or ``cfg`` at fewer decoder layers) on the card and on the CPU plain
    path, selection by selection and post-processed output by output.
    -> fp32 launches."""
    import dataclasses

    import torch

    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    model = init_random(HiPAD(cfg, device=dev), SEED)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)
    n_deform, per_call = _launch_plan(cfg)
    per_call = {k: v for k, v in per_call.items() if not k.endswith(("_bwd", "_bwd_lk"))}
    n_frames = WARMUP_FRAMES + TIMED_FRAMES

    def frame_inputs(i):
        return images + 1e-3 * i, dict(metas, timestamp=metas["timestamp"] + 0.5 * i)

    launches = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        _reset_counts()
        banks, times = None, []
        with torch.no_grad(), torch.autocast("cuda", dtype=dtype,
                                             enabled=dtype != torch.float32):
            for i in range(n_frames):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out, banks = model(*frame_inputs(i), banks)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                leaves = list(_flat(out)) + [
                    (f"bank.{n}.{f.name}", getattr(getattr(banks, n), f.name))
                    for n in ("det", "ego", "plan") for f in dataclasses.fields(getattr(banks, n))]
                bad = [k for k, v in leaves
                       if v.is_floating_point() and not torch.isfinite(v).all()]
                if bad:
                    fail(f"{tag} {name} frame {i}: non-finite outputs {bad[:5]}")
        counts = _kernel_counts()
        timed = sorted(times[WARMUP_FRAMES:])
        say(f"{tag} bs=1 {name} on {card}: {n_frames} chained frames, every output finite; per "
            f"frame median {statistics.median(timed):.2f} ms, min {timed[0]:.2f}, max "
            f"{timed[-1]:.2f} (host clock, sync per frame, frames {WARMUP_FRAMES}..{n_frames - 1})"
            f"; launches " + ", ".join(f"{k} {counts[k]} (expected {n_frames * n_deform * v})"
                                       for k, v in per_call.items()))
        for kname, n in counts.items():
            want = n_frames * n_deform * per_call.get(kname, 0)
            if n != want or (kname in per_call and n == 0):
                fail(f"{tag}: {kname} launched {n} times, expected {want}")
        launches = launches or counts
    if cpu_cfg is not cfg:
        del model
        torch.cuda.empty_cache()
        model = init_random(HiPAD(cpu_cfg, device=dev), SEED)
        say(f"{tag} frame 0 against the CPU at {cpu_cfg.operation_order.count('refine')} "
            f"decoder layers (the chained frames ran {cfg.operation_order.count('refine')})")
    _frame0_against_cpu(tag, cpu_cfg, model, *frame_inputs(0))
    del model
    torch.cuda.empty_cache()
    return launches


def _options_train(card: str):
    """One training step of frame A's config without dropout and GridMask,
    bs=1 fp32, on the card and on the CPU plain path with the card's picks
    (keypoint and level top-k, bank top-k) and Hungarian assignments
    recorded, loss by loss under phase 5's tolerance. The picks' score gaps
    are printed, not held: a keypoint's importance counts its mass only in
    the cameras it lies in, so a keypoint on an image border that lies in a
    camera on one device and not on the other moves its importance by a
    whole camera's mass (seen on an H100: 1.3e-2) while the losses agree to
    1e-5 of their values. -> the card's launches."""
    import torch

    from hipad_torch.configs.model import stage2_serving
    from hipad_torch.data import synthetic
    from hipad_torch.models.deformable import DeformableAggregation
    from hipad_torch.models.detector import HiPAD
    from hipad_torch.targets import matching
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    cfg = stage2_serving(drop_out=0.0, use_grid_mask=False, **OPTIONS_A)
    n_deform, per_call = _launch_plan(cfg)
    batch = {k: torch.as_tensor(v) for k, v in synthetic.make_batch(cfg, 1, seed=SEED).items()}
    weights = {k: v.detach().cpu().clone() for k, v in
               init_random(HiPAD(cfg, device=dev), SEED).state_dict().items()}
    solved = []
    assign_many = matching.assign_many

    def recording(problems):
        cols = assign_many(problems)
        solved.append([c.cpu() for c in cols])
        return cols

    matching.assign_many = recording
    results, card_calls, launches = [], None, []
    try:
        # the card, the card under torch's deterministic flag, the CPU
        for device, on in ((dev, False), (dev, True), (torch.device("cpu"), False)):
            t0 = time.perf_counter()
            model = HiPAD(cfg, device=device)
            model.load_state_dict(weights)
            for m in model.modules():
                if isinstance(m, DeformableAggregation):
                    m.attn_drop = 0.0
            step = make_train_step(cfg, model, AdamW(model.named_parameters()))
            _reset_counts()
            with flag(on), _Selections(None if on else card_calls, "[options] A's step",
                                       hold=False) as sel:
                _, metrics = step(None, {k: v.to(device) for k, v in batch.items()},
                                  torch.Generator(device=device))
            if device.type == "cuda":
                launches.append(_kernel_counts())
                card_calls = card_calls or sel.calls
            results.append({k: float(v) for k, v in metrics.items()})
            say(f"[options] A's training step (drop_out 0, no GridMask, fp32) on {device.type}"
                f"{' under torch.use_deterministic_algorithms(True)' if on else ''}: "
                f"{time.perf_counter() - t0:.1f} s, {len(sel.calls)} selections"
                + (f", {sel.differ} ranks picked differently by the CPU, largest score gap "
                   f"{sel.worst:.3e} (the CPU took the card's picks; the losses are held)"
                   if device.type == "cpu" else ""))
            del model, step
    finally:
        matching.assign_many = assign_many
    for counts, on in zip(launches, (False, True)):
        want = {k: n_deform * v for k, v in _launch_plan(cfg)[1].items()}
        want["lsa_assign"] = MATCH_LAUNCHES
        say(f"[options] A's step launches on the card{' under the flag' if on else ''}: "
            + ", ".join(f"{k} {counts[k]} (expected {v})" for k, v in want.items()))
        for kname, n in counts.items():
            if n != want.get(kname, 0) or (kname in want and n == 0):
                fail(f"[options] step: {kname} launched {n} times, expected "
                     f"{want.get(kname, 0)}")
    differ = [i for i, (a, b) in enumerate(zip(solved[0], solved[2])) if not torch.equal(a, b)]
    if differ:
        say(f"[options] the Hungarian assignments differ between card and CPU in problem(s) "
            f"{differ} (0 = det, 1 = map, all layers stacked)")
    cpu_m = results[2]
    for card_m, what in zip(results[:2], ("card", "card under the flag")):
        for k in sorted(cpu_m):
            rtol, atol = (GRAD_NORM_RTOL, 0.0) if k == "grad_norm" else (TRAIN_RTOL, TRAIN_ATOL)
            err, tol = abs(card_m[k] - cpu_m[k]), rtol * abs(cpu_m[k]) + atol
            say(f"[options] A's step {what} vs CPU {k}: card {card_m[k]:.6f} cpu "
                f"{cpu_m[k]:.6f} abs_err {err:.3e} (tol {tol:.3e}) "
                f"{'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                fail(f"[options] {what} and CPU disagree on A's step {k}")
    torch.cuda.empty_cache()
    return launches


def phase_options(cfg, card: str):
    """The decoder's model options: K2-lk and K2-bwd-lk against their plain
    versions; the reference route against the oracle on the card; frames
    A, B and C (chained, fp32 and bf16, frame 0 against the CPU); one
    training step of A against the CPU. -> (kernel records, launches of
    A's frames, of A's step)."""
    from hipad_torch.configs.model import (SINGLE_FRAME_LAYER, TEMPORAL_FRAME_LAYER, stage2,
                                           stage2_serving)

    t0 = time.perf_counter()
    recs = _options_kernels(cfg, card)
    _options_reference_route(card)
    cfg_a = stage2_serving(**OPTIONS_A)
    frame_launches = _options_frames("[options] A", cfg_a, cfg_a, card)
    short = SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * (OPTIONS_CPU_LAYERS - 1)
    for tag, opts in (("[options] B", OPTIONS_B), ("[options] C", OPTIONS_C)):
        _options_frames(tag, stage2(**opts), stage2(operation_order=short, **opts), card)
    step_launches = _options_train(card)
    say(f"[options] {time.perf_counter() - t0:.1f} s")
    return recs, frame_launches, step_launches


AGENT_WARMUP, AGENT_TICKS = 2, 10


def phase_agent(card: str, weights):
    """``AgentCore(stage2_serving_det(), seeded weights)`` in fp32 over the
    fake simulator at its 6 x 1600x900 uint8 cameras, JPEG q20 and the native
    resize/crop: 2 warm-up and 20 timed ticks. -> K1/K2 launches."""
    import numpy as np
    import torch

    from hipad_torch.agent.core import AgentCore
    from hipad_torch.agent.replay import FakeSim
    from hipad_torch.configs.model import stage2_serving_det
    from hipad_torch.ops import kernels

    t0 = time.perf_counter()
    agent = AgentCore(stage2_serving_det(), weights, dtype=torch.float32, device=DEVICE)
    sim = FakeSim(seed=SEED)
    say(f"[agent] AgentCore(stage2_serving_det) fp32 built in {time.perf_counter() - t0:.1f} s; "
        f"{len(agent.banks)} banks in round robin; cameras {sim.img_hw[1]}x{sim.img_hw[0]} uint8")
    for k in kernels.KERNELS:
        k.launches = 0
    phases, ticks = [], []
    for t in range(AGENT_WARMUP + AGENT_TICKS):
        obs = sim.observe()
        t1 = time.perf_counter()
        control = agent.run_step(obs)
        ticks.append((time.perf_counter() - t1) * 1e3)
        phases.append(dict(agent.last_phase_ms))
        vals = [control["steer"], control["throttle"], control["brake"]]
        if not (np.isfinite(vals).all() and -1 <= vals[0] <= 1 and 0 <= vals[1] <= 0.75
                and 0 <= vals[2] <= 1):
            fail(f"agent tick {t}: control {vals} not finite or outside the clip ranges")
        sim.apply(control)
    if any(b is None for b in agent.banks[:min(len(agent.banks), len(ticks))]):
        fail("agent: a bank of the round robin was never written")
    counts = {k.name: k.launches for k in kernels.KERNELS}
    timed = phases[AGENT_WARMUP:]
    med = {k: statistics.median(p[k] for p in timed) for k in timed[0]}
    say(f"[agent] {AGENT_TICKS} ticks after {AGENT_WARMUP} on {card}: every control finite and "
        f"clipped; per tick median host_preproc {med['host_preproc']:.2f} ms "
        f"[{min(p['host_preproc'] for p in timed):.2f}, "
        f"{max(p['host_preproc'] for p in timed):.2f}], upload_infer "
        f"{med['upload_infer']:.2f} ms [{min(p['upload_infer'] for p in timed):.2f}, "
        f"{max(p['upload_infer'] for p in timed):.2f}], run_step "
        f"{statistics.median(ticks[AGENT_WARMUP:]):.2f} ms (host clock); "
        f"K1 {counts['coarse_sample']} and K2 {counts['patch_sample']} launches over "
        f"{len(ticks)} ticks")
    if not counts["coarse_sample"] or not counts["patch_sample"]:
        fail("agent: the sampler kernels were not launched")
    del agent
    torch.cuda.empty_cache()
    return counts


CL_TICKS, CL_VIZ_EVERY, CL_BENCH_TICKS = 12, 4, 30


def _location_to_gps(x: float, y: float, lat_ref: float = 42.0, lon_ref: float = 2.0):
    """CARLA world [x, y] -> GNSS (lat, lon), the inverse of the planner's
    ``gps_to_location`` at the agent's default town origin."""
    from hipad_torch.agent.planner import EARTH_RADIUS_EQUA

    scale = math.cos(lat_ref * math.pi / 180.0)
    lon = (x + scale * lon_ref * math.pi * EARTH_RADIUS_EQUA / 180.0) \
        * 180.0 / (math.pi * EARTH_RADIUS_EQUA * scale)
    my = scale * EARTH_RADIUS_EQUA * math.log(math.tan((90.0 + lat_ref) * math.pi / 360.0)) - y
    lat = 360.0 / math.pi * math.atan(math.exp(my / (EARTH_RADIUS_EQUA * scale))) - 90.0
    return lat, lon


def _cl_agent(work: str):
    """``HiPADTorchAgent`` through the leaderboard's stub: setup, sensors
    and ``CL_TICKS`` ticks of leaderboard-format ``input_data`` (six BGRA
    1600x900 cameras, IMU, GNSS, speedometer) driving along a straight
    route at 5 m/s, composites every ``CL_VIZ_EVERY`` ticks -> its
    ``upload_infer`` and ``host_preproc`` per tick."""
    from types import SimpleNamespace

    import numpy as np

    from hipad_torch.agent import carla_adapter
    from hipad_torch.agent.calib import CAMERAS, IMG_H, IMG_W

    viz = os.path.join(work, "viz")

    class SmokeAgent(carla_adapter.HiPADTorchAgent):
        def _agent_core_kwargs(self):
            return {"visualize_dir": viz, "visualize_interval": CL_VIZ_EVERY}

    os.environ["SAVE_PATH"] = work
    t0 = time.perf_counter()
    agent = SmokeAgent("host", "port")
    agent.setup("+smoke+config=stage2_serving_det")
    if next(agent.core.model.parameters()).device.type != "cuda":
        fail("[closed-loop] the agent's model is not on the card")
    specs = agent.sensors()
    cams = [s for s in specs if s["type"] == "sensor.camera.rgb"]
    if {c["id"] for c in cams} != set(CAMERAS) or len(specs) != len(CAMERAS) + 3:
        fail(f"[closed-loop] sensor rig {[s['id'] for s in specs]}")
    world, gps = [], []
    for i in range(20):
        x, y = 1.0 + 4.0 * i, 2.0
        world.append((SimpleNamespace(location=SimpleNamespace(x=x, y=y, z=0.0)), 4))
        lat, lon = _location_to_gps(x, y)
        gps.append(({"lat": lat, "lon": lon, "z": 0.0}, 4))
    agent._global_plan, agent._global_plan_world_coord = gps, world
    say(f"[closed-loop] HiPADTorchAgent (entry point {carla_adapter.get_entry_point()}) set up "
        f"with '+smoke+config=stage2_serving_det' in {time.perf_counter() - t0:.1f} s: "
        f"{len(specs)} sensors, cameras {IMG_W}x{IMG_H}, {len(agent.core.banks)} banks, "
        f"bf16 on the card")
    rng = np.random.RandomState(SEED)
    phases = []
    for t in range(CL_TICKS):
        lat, lon = _location_to_gps(1.0 + 0.25 * t, 2.0)
        data = {"GPS": (t, np.array([lat, lon, 0.0])),
                "IMU": (t, np.array([0.1, 0.0, 9.8, 0.0, 0.0, 0.01, math.pi / 2])),
                "SPEED": (t, {"speed": 5.0})}
        for cam in CAMERAS:
            data[cam] = (t, rng.randint(0, 255, (IMG_H, IMG_W, 4), np.uint8))
        out = agent.run_step(data, 0.05 * t)
        vals = [out["steer"], out["throttle"], out["brake"]]
        if not (np.isfinite(vals).all() and -1 <= vals[0] <= 1 and 0 <= vals[1] <= 0.75
                and 0 <= vals[2] <= 1):
            fail(f"[closed-loop] tick {t}: control {vals} not finite or outside the clip ranges")
        phases.append(dict(agent.core.last_phase_ms))
    info = json.load(open(os.path.join(agent.save_path, "metric_info.json")))
    if sorted(info, key=int) != [str(t) for t in range(CL_TICKS)]:
        fail(f"[closed-loop] metric_info.json holds ticks {sorted(info)}")
    want = [f"{t:06d}.jpg" for t in range(0, CL_TICKS, CL_VIZ_EVERY)]
    dumps = sorted(os.listdir(viz))
    if dumps != want or any(os.path.getsize(os.path.join(viz, d)) == 0 for d in dumps):
        fail(f"[closed-loop] composites {dumps}, expected {want}")
    from PIL import Image

    size = Image.open(os.path.join(viz, dumps[0])).size
    med = {k: statistics.median(p[k] for p in phases[2:]) for k in phases[0]}
    say(f"[closed-loop] {CL_TICKS} ticks: every control finite and clipped, metric_info.json "
        f"with {len(info)} ticks, composites {dumps} ({size[0]}x{size[1]}); median of ticks "
        f"2..{CL_TICKS - 1} host_preproc {med['host_preproc']:.2f} ms, upload_infer "
        f"{med['upload_infer']:.2f} ms (host clock; the dumps fall outside both phases)")
    agent.destroy()


def phase_closed_loop(card: str):
    """The leaderboard agent (``_cl_agent``), then ``closed_loop_serving_bench.main``
    for ``CL_BENCH_TICKS`` ticks of ``stage2_serving_det`` and
    ``serving_error_sweep.main`` decoder-only at full width, every row. ->
    the kernels' launches over the three."""
    import tempfile

    import numpy as np
    import torch

    from hipad_torch.tools import closed_loop_serving_bench, serving_error_sweep

    _reset_counts()
    with tempfile.TemporaryDirectory(prefix="hipad_closed_loop_") as work:
        saved = os.environ.get("SAVE_PATH")
        try:
            _cl_agent(work)
        finally:
            os.environ.pop("SAVE_PATH", None)
            if saved is not None:
                os.environ["SAVE_PATH"] = saved
        torch.cuda.empty_cache()
        before = _kernel_counts()
        summary = closed_loop_serving_bench.main(
            ["--ticks", str(CL_BENCH_TICKS), "--config", "stage2_serving_det",
             "--out", os.path.join(work, "ticks.jsonl")])
        n = {k: v - before[k] for k, v in _kernel_counts().items() if v > before[k]}
        if not summary["controls_sane"] or summary["ticks"] != CL_BENCH_TICKS:
            fail(f"[closed-loop] serving bench: {summary}")
        say(f"[closed-loop] closed_loop_serving_bench stage2_serving_det bf16 on {card}: "
            f"{summary['ticks']} ticks, {summary['warm_ticks']} warm: tick median "
            f"{summary['tick_ms_median']} ms (p90 {summary['tick_ms_p90']}), "
            f"{summary['ticks_per_s_warm']} ticks/s, host_preproc median "
            f"{summary['host_preproc_ms_median']} ms, upload_infer median "
            f"{summary['upload_infer_ms_median']} ms (host clock); native_preproc "
            f"{summary['native_preproc']}; launches {n}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = serving_error_sweep.main([])
    if len(rows) != len(serving_error_sweep.ROWS):
        fail(f"[closed-loop] the sweep ran {len(rows)} of {len(serving_error_sweep.ROWS)} rows")
    for r in rows:
        vals = [v for k, v in r.items() if k not in ("config", "launches")]
        if not np.isfinite(vals).all():
            fail(f"[closed-loop] sweep row {r['config']}: a delta is not finite")
        lk = "sampler_level_k" if "level_k" in r["config"] else ""
        fine = "patch_sample_lk" if lk else "patch_sample"
        if not r["launches"].get("coarse_sample") or not r["launches"].get(fine):
            fail(f"[closed-loop] sweep row {r['config']}: launches {r['launches']}")
    say(f"[closed-loop] serving_error_sweep (decoder only, stage 2 at 352x640, seeded random "
        f"weights) on {card}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s, every delta "
        f"finite; launches per row (two frames): "
        + "; ".join(f"{r['config']}: {r['launches']}" for r in rows))
    return _kernel_counts()

def phase_gather(card: str):
    """P2-P4 at the probe tool's shapes: the tool's own run (launches), then
    each kernel against its plain version (equal) and timed against it and
    ``torch.index_select``. -> ({name: _Rec}, launches in the tool's run)."""
    import numpy as np
    import torch

    from hipad_torch.ops import gather, kernels
    from hipad_torch.tools import probe_gather

    dev = torch.device(DEVICE)
    recs, launches = {}, {}
    for which, kernel in (("A", kernels.gather_rows_f32), ("D", kernels.gather_rows_bf16),
                          ("C", kernels.gather_rows_f32_every8)):
        kernel.launches = 0
        _, _, correct, tool_ms = probe_gather.run(which, DEVICE, time_it=True)
        launches[kernel.name] = kernel.launches
        fn, _, _, stride = gather.PROBES[which]
        rng = np.random.RandomState(0)
        rows = rng.randn(probe_gather.N, gather.ROW).astype(np.float32)
        idx = torch.as_tensor(rng.randint(0, probe_gather.N, probe_gather.M).astype(np.int32),
                              device=dev)
        idx[0], idx[8] = 0, probe_gather.N - 1  # both ends, also among P4's every 8th
        table = gather.make_table(which, rows, dev)
        got = fn(idx, table)
        ref = gather.gather_rows_plain(table, idx, stride)
        torch.cuda.synchronize()
        equal = torch.equal(got, ref)
        say(f"[gather] {kernel.probe} {kernel.name} (probe {which}) table "
            f"{tuple(table.shape)} {str(table.dtype)[6:]}, {idx.numel()} indices, stride "
            f"{stride}: the tool says correct={correct}; kernel == plain version: "
            f"{'equal' if equal else 'DIFFERENT'}; {launches[kernel.name]} launches in the "
            f"tool's timed run (median {tool_ms:.4f} ms)")
        if not (equal and correct):
            fail(f"{kernel.name} disagrees with its plain version")
        flat = table.reshape(-1, gather.ROW)
        sel = idx[::stride].contiguous()
        def plain():
            return gather.gather_rows_plain(table, idx, stride)

        def kern():
            return fn(idx, table)

        def library():
            return torch.index_select(flat, 0, sel)

        dev_ms, call = _times([plain, kern, library, library, kern, plain])
        rec = _Rec()
        rec.err = float((got.float() - ref.float()).abs().max())
        rec.ms, rec.per_call_ms = min(dev_ms[1], dev_ms[4]), min(call[1], call[4])
        rec.plain_ms, rec.library_ms = min(dev_ms[0], dev_ms[5]), min(dev_ms[2], dev_ms[3])
        uniq = int(torch.unique(sel).numel())
        row_bytes = gather.ROW * table.element_size()
        rec.add_bound(bound(uniq * row_bytes + _nbytes(got) + _nbytes(sel), 0.0))
        recs[kernel.name] = rec
        say(f"[gather] {kernel.name} on {card}: device time kernel {rec.ms:.4f} ms, plain "
            f"{rec.plain_ms:.4f} ms, torch.index_select (the same function) "
            f"{rec.library_ms:.4f} ms ({QUEUED}, in turns plain/kernel/index_select/"
            f"index_select/kernel/plain: the kernel "
            f"{'at or below' if rec.ms <= rec.library_ms else 'ABOVE'} index_select); each "
            f"call with its Python launch, CUDA events, median of 20: kernel {rec.per_call_ms:.4f} ms, plain {min(call[0], call[5]):.4f} ms, "
            f"index_select {min(call[2], call[3]):.4f} ms; bound "
            f"{rec.bound_ms:.4f} ms (bytes: {uniq} distinct "
            f"table rows of {row_bytes} B read, {_nbytes(got) / 1e6:.2f} MB written, the "
            f"indices; the {_nbytes(table) / 1e6:.2f} MB table fits in the 50 MB L2, so the "
            f"HBM bound is a floor the L2 may beat)")
    return recs, launches


def _tensors(out):
    """The tensors of a wrapper's output: a tensor, or a tuple of tensors and
    lists of tensors."""
    return [t for v in (out if isinstance(out, tuple) else (out,))
            for t in (v if isinstance(v, list) else [v])]


def _other_tree(other: str):
    """The ``hipad_torch`` package of the checkout at ``other``, imported as
    ``other_hipad_torch`` beside this tree's: its modules import each other
    relatively, and its kernels build into that checkout's ``build/``."""
    import importlib
    import importlib.util

    root = os.path.join(os.path.abspath(other), "hipad_torch")
    spec = importlib.util.spec_from_file_location(
        "other_hipad_torch", os.path.join(root, "__init__.py"), submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg  # its dataclasses look their module up there
    spec.loader.exec_module(pkg)
    return {m: importlib.import_module(f"other_hipad_torch.{m}") for m in (
        "ops.kernels", "ops.sampling", "configs.model", "models.detector", "postprocess",
        "train.optim", "train.train_step", "agent.core", "targets.matching")}


def _their_coarse(kernels, acc, maps, pts, wts, levels):
    """The coarse levels as the other tree runs them: its K1 in one call
    where it has ``coarse_sample``; else (the per-level K1 of PRs 1-4) its
    glue, ``ops/sampling.py:298-313`` there: camera-major coordinates and
    masked weights, one K1 launch per level, each added to acc."""
    if hasattr(kernels, "coarse_sample"):
        return kernels.coarse_sample(acc, maps, pts, wts, levels)
    bs, M0, cams, _ = pts.shape
    L, G = wts.shape[-2:]
    B = bs * cams
    inside = ((pts > 0.0) & (pts < 1.0)).all(dim=-1)
    xf = pts[..., 0].permute(0, 2, 1).reshape(B, M0).float()
    yf = pts[..., 1].permute(0, 2, 1).reshape(B, M0).float()
    insf = inside.permute(0, 2, 1).reshape(B, M0)
    wf = wts.permute(0, 2, 1, 3, 4).reshape(B, M0, L, G).float() * insf[..., None, None]
    out = acc
    for lvl, feat in zip(levels, maps):
        h, w, C = feat.shape[2:]
        out = out + kernels.interp_sample_camsum(
            feat.reshape(B, h, w, C), (xf * w - 0.5).contiguous(), (yf * h - 0.5).contiguous(),
            wf[:, :, lvl].contiguous(), bs, cams)
    return out


def _compare_k3_and_gathers(tree, cfg):
    """``compare_against``'s cases for K3 (a stage-2 fp32 step's det and map
    problems at bs=1, through each tree's ``assign_many``) and P2-P4 (the
    probe tool's shapes and data), each held bit for bit."""
    import numpy as np
    import torch

    from hipad_torch.ops import gather, kernels
    from hipad_torch.targets import matching
    from hipad_torch.tools import probe_gather

    probs = step_problems(cfg, (1,))[0][1]
    iterations = [[] for _ in probs]
    for (c, m), it in zip(probs, iterations):
        matching.assign_plain(c, m, it)
    chain = max(max(it) for it in iterations)
    their_many = tree["targets.matching"].assign_many
    cases = [(f"K3 a stage-2 step's det and map at bs=1, the longest chain {chain} inner "
              f"iterations (bit for bit)", lambda: their_many(probs),
              lambda: matching.assign_many(probs))]
    theirs = tree["ops.kernels"]
    rng = np.random.RandomState(0)
    rows = rng.randn(probe_gather.N, gather.ROW).astype(np.float32)
    idx = torch.as_tensor(rng.randint(0, probe_gather.N, probe_gather.M).astype(np.int32),
                          device=DEVICE)
    for which, name in (("A", "gather_rows_f32"), ("D", "gather_rows_bf16"),
                        ("C", "gather_rows_f32_every8")):
        flat = gather.make_table(which, rows, DEVICE).reshape(-1, gather.ROW)
        ours = getattr(kernels, name)
        cases.append((f"{ours.probe} {name} (bit for bit)",
                      lambda f=flat, k=getattr(theirs, name): k(f, idx),
                      lambda f=flat, k=ours: k(f, idx)))
    return cases


def _their_routes(wrapper):
    """(route name, function) of each design a tree's backward wrapper
    launches: each route it declares, through ``launch(route, ...)`` (the
    trees where a wrapper could hold several); else (None, the wrapper),
    its one design."""
    routes = getattr(wrapper, "routes", None)
    if not routes:
        return [(None, wrapper)]
    return [(r.name, lambda *a, r=r: wrapper.launch(r, *a)) for r in routes]


def compare_against(other: str, cfg, card: str):
    """The kernels of the checkout at ``other`` against this tree's, at
    phase 3 and 3b's shapes (bs=1, fp32), K3 at phase 5f's and P2-P4 at
    phase 8's: device time in turns theirs/ours/ours/theirs, and the largest
    difference of their outputs. K1 is held as the coarse levels of one
    deformable call (the other tree's launches and glue), and the whole
    sampler call as well."""
    import torch

    from hipad_torch.ops import kernels, sampling

    tree = _other_tree(other)
    theirs = tree["ops.kernels"]
    lib = theirs.library()
    say(f"[compare] {other}: built {lib.path} in {lib.build_seconds:.1f} s")
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    acc, maps, pts, wts, levels = _k1_inputs(cfg, g, dev, torch.float32)
    their_k1 = "1 launch" if hasattr(theirs, "coarse_sample") else f"{len(levels)} launches, glue"
    cases.append((f"K1 levels {levels} (theirs: {their_k1})",
                  lambda: _their_coarse(theirs, acc, maps, pts, wts, levels),
                  lambda: kernels.coarse_sample(acc, maps, pts, wts, levels)))
    for lvl in levels:
        args = _k1_bwd_inputs(cfg, g, dev, lvl, torch.float32)
        gout = torch.randn(1, args[1].shape[1], args[0].shape[-1], generator=g, device=dev)
        bwd_args = args[:4] + (gout,) + args[4:]
        for route, fn in _their_routes(theirs.interp_sample_camsum_bwd):
            label = f", theirs route {route}" if route else ""
            cases.append((f"K1-bwd level {lvl} ({args[0].shape[1]}x{args[0].shape[2]}){label}",
                          lambda a=bwd_args, f=fn: f(*a),
                          lambda a=bwd_args: kernels.interp_sample_camsum_bwd(*a)))
    k2_args = _k2_inputs(cfg, g, dev, torch.float32)
    maps2, cam, x, y, w, cam_k = k2_args
    W0 = maps2[0].shape[3]
    x[:, ::50] = ((x[:, ::50] * W0 - 0.5).round() + 0.5) / W0
    gout = torch.randn(x.shape[0], x.shape[1] // cam_k, maps2[0].shape[-1], generator=g,
                       device=dev)
    cases.append(("K2 (bit for bit)", lambda: theirs.patch_sample(*k2_args),
                  lambda: kernels.patch_sample(*k2_args)))
    bwd2 = (maps2, cam, x, y, w, gout, cam_k)
    for route, fn in _their_routes(theirs.patch_sample_bwd):
        label = f", theirs route {route}" if route else ""
        cases.append((f"K2-bwd{label}", lambda f=fn: f(*bwd2),
                      lambda: kernels.patch_sample_bwd(*bwd2)))
    if hasattr(theirs, "patch_sample_bwd_lk"):  # the level-k variant, phase 9's shapes
        lk = _lk_inputs(cfg, g, dev, torch.float32, True)
        glk = torch.randn(x.shape[0], x.shape[1] // cam_k, maps2[0].shape[-1], generator=g,
                          device=dev)
        bwd_lk = lk[:5] + (glk, cam_k, lk[6])
        for route, fn in _their_routes(theirs.patch_sample_bwd_lk):
            label = f", theirs route {route}" if route else ""
            cases.append((f"K2-bwd-lk{label}", lambda f=fn: f(*bwd_lk),
                          lambda: kernels.patch_sample_bwd_lk(*bwd_lk)))
    for what, name, args in step_bwd_calls():
        for route, fn in _their_routes(getattr(theirs, name)):
            label = f", theirs route {route}" if route else ""
            cases.append((f"{what}{label}", lambda f=fn, a=args: f(*a),
                          lambda n=name, a=args: getattr(kernels, n)(*a)))
    fmaps = list(maps2) + maps  # levels 0-3 of one pyramid
    topk = dict(cam_k=cfg.sampler_cam_k, matmul_levels=cfg.sampler_matmul_levels,
                cam_renorm=cfg.sampler_cam_renorm)
    their_sampler = tree["ops.sampling"].deformable_samples_topk_flat
    # timed by CUDA events around each call: a call waits for the host once
    # (the fine levels' weights are taken by a list index, whose copy to the
    # card synchronises the stream), so its calls cannot queue behind a sleep
    cases.append(("sampler call (deformable_samples_topk_flat: K2, K1 and their glue)",
                  lambda: their_sampler(fmaps, pts, wts, **topk),
                  lambda: sampling.deformable_samples_topk_flat(fmaps, pts, wts, **topk)))
    cases += _compare_k3_and_gathers(tree, cfg)
    for what, old_fn, new_fn in cases:
        a, b = old_fn(), new_fn()
        diff = max(_max_err(u, v)[0] for u, v in zip(_tensors(a), _tensors(b)))
        scale = max(_max_err(u, u)[1] for u in _tensors(a))
        queued = not what.startswith("sampler call")
        t = (_device_ms if queued else _timed)([old_fn, new_fn, new_fn, old_fn])
        old, new = min(t[0], t[3]), min(t[1], t[2])
        how = QUEUED if queued else "CUDA events around each of 20 calls, median"
        chain = re.search(r"longest chain (\d+)", what)
        per_iter = (f"; per inner iteration theirs {old / int(chain[1]) * 1e3:.3f} us, ours "
                    f"{new / int(chain[1]) * 1e3:.3f} us" if chain else "")
        say(f"[compare] {what} fp32 on {card}: theirs {old:.4f} ms, ours {new:.4f} ms "
            f"({new / old:.3f}x; {how}, in turns theirs/ours/ours/theirs){per_iter}; outputs "
            f"differ by {diff:.3e} (scale {scale:.3e}, {diff / scale:.1e} of it)")
        if not diff <= KERNEL_RTOL * scale:
            fail(f"{what}: the two trees disagree by more than {KERNEL_RTOL:g} of scale")
        if "bit for bit" in what and not all(torch.equal(u, v) for u, v in zip(
                _tensors(a), _tensors(b))):
            fail(f"{what}: the two trees' outputs are not the same bits")
    return tree


def _launch_counts(kernels_module):
    return {k.name: k.launches for k in kernels_module.KERNELS if k.launches}


def _profiled(fn, by_name=None, host=None):
    """(CUDA kernels launched, device busy ms) of one call of fn, by
    torch.profiler; ``by_name``, a dict, gets each kernel name's [launches,
    device ms] added; ``host``, a list, gets the count of the host's launch
    calls (kernels, graphs, copies and fills) appended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hipad_torch.probe import _merged_busy

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if host is not None:
        host.append(sum(e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(
            ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset"))
            for e in prof.events()))
    for e in ks if by_name is not None else ():
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += (e.time_range.end - e.time_range.start) / 1e3
    return len(ks), _merged_busy([(e.time_range.start, e.time_range.end) for e in ks]) / 1e3


def _in_turns(what, runs, card, warmup=WARMUP_FRAMES, rounds=SERVE_ROUNDS):
    """Each tree's iteration of one path in turns (theirs, ours; then ours,
    theirs; and so on), host clock with a sync around each, after
    ``warmup`` rounds; then each tree's sampler-kernel launches per
    iteration over the timed rounds, and one more iteration of each under
    torch.profiler (all its kernel launches, its device busy time)."""
    import torch

    ms = {name: [] for name in runs}
    order = list(runs)
    for i in range(warmup + rounds):
        if i == warmup:
            for _, kmod in runs.values():
                for k in kmod.KERNELS:
                    k.launches = 0
        for name in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[name][0]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    a, b = (ms[n][warmup:] for n in order)
    diff = [y - x for x, y in zip(a, b)]
    say(f"[compare] {what} on {card}, {rounds} rounds after {warmup} (host clock, sync around "
        f"each, order alternating): theirs median {statistics.median(a):.2f} ms "
        f"[{min(a):.2f}, {max(a):.2f}], ours {statistics.median(b):.2f} ms "
        f"[{min(b):.2f}, {max(b):.2f}], ours - theirs per round median "
        f"{statistics.median(diff):.2f} ms [{min(diff):.2f}, {max(diff):.2f}]")
    for name, (fn, kmod) in runs.items():
        per = {k: v / rounds for k, v in _launch_counts(kmod).items()}
        n, busy = _profiled(fn)
        say(f"[compare] {what} {name}: sampler kernel launches per iteration {per}; one more "
            f"iteration profiled: {n} kernel launches, device busy {busy:.2f} ms")


def compare_paths(tree, card: str):
    """Phases 4-7's paths in both trees, fp32, bs=1, in turns: the stage-2
    frame, the training step, the serving frame with post-processing and
    the agent's tick; the two models of each path share their weights."""
    import numpy as np
    import torch

    from hipad_torch import postprocess
    from hipad_torch.agent.core import AgentCore
    from hipad_torch.agent.replay import FakeSim
    from hipad_torch.configs import model as configs
    from hipad_torch.data import synthetic
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.ops import kernels
    from hipad_torch.train.optim import AdamW
    from hipad_torch.train.train_step import make_train_step
    from hipad_torch.weights import init_random

    dev = torch.device(DEVICE)
    theirs_k = tree["ops.kernels"]

    def pair(name):
        cfgs = (getattr(tree["configs.model"], name)(), getattr(configs, name)())
        ours = init_random(HiPAD(cfgs[1], device=dev), SEED)
        theirs = tree["models.detector"].HiPAD(cfgs[0], device=dev)
        theirs.load_state_dict(ours.state_dict())
        return cfgs, theirs, ours

    for name in ("stage2", "stage2_serving_det"):
        cfgs, theirs, ours = pair(name)
        images, metas = batch_to_torch(synthetic.make_batch(cfgs[1], 1, seed=SEED), dev)
        post = (tree["postprocess"].post_process_arrays, postprocess.post_process_arrays)
        decode = name != "stage2"

        def frame_fn(m, c, pp, state):
            def run():
                i = state["i"]
                mt = dict(metas, timestamp=metas["timestamp"] + 0.5 * i)
                with torch.no_grad():
                    out, state["banks"] = m(images + 1e-3 * i, mt, state["banks"])
                    if decode:
                        pp(c, out, mt["gt_ego_fut_cmd"])
                state["i"] += 1
            return run

        runs = {"theirs": (frame_fn(theirs, cfgs[0], post[0], {"i": 0, "banks": None}), theirs_k),
                "ours": (frame_fn(ours, cfgs[1], post[1], {"i": 0, "banks": None}), kernels)}
        _in_turns(f"{name} frame fp32{' with post_process_arrays' if decode else ''}", runs, card)
        if decode:
            weights = {k: v.detach().clone() for k, v in ours.state_dict().items()}
        del theirs, ours, runs
        torch.cuda.empty_cache()

    cfgs, theirs, ours = pair("stage2")
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic.make_batch(cfgs[1], 1, seed=SEED).items()}
    steps = (tree["train.train_step"].make_train_step(
                 cfgs[0], theirs, tree["train.optim"].AdamW(theirs.named_parameters())),
             make_train_step(cfgs[1], ours, AdamW(ours.named_parameters())))

    def step_fn(step, state):
        def run():
            i = state["i"]
            b = dict(batch, timestamp=batch["timestamp"] + 0.5 * i,
                     images=batch["images"] + 1e-3 * i)
            state["banks"], _ = step(state["banks"], b, state["gen"])
            state["i"] += 1
        return run

    runs = {n: (step_fn(st, {"i": 0, "banks": None,
                              "gen": torch.Generator(device=dev).manual_seed(SEED)}), km)
            for n, st, km in (("theirs", steps[0], theirs_k), ("ours", steps[1], kernels))}
    _in_turns("stage2 training step fp32", runs, card, WARMUP_STEPS, PAIRED_ROUNDS)
    for name, st in zip(("theirs:", "ours:"), steps):
        count_step_syncs(name, st, batch, card)
    del theirs, ours, steps, runs
    torch.cuda.empty_cache()

    cfg = configs.stage2_serving_det()
    agents = {"theirs": (tree["agent.core"].AgentCore(
                  tree["configs.model"].stage2_serving_det(), weights, dtype=torch.float32,
                  device=DEVICE), theirs_k),
              "ours": (AgentCore(cfg, weights, dtype=torch.float32, device=DEVICE), kernels)}
    sim = FakeSim(seed=SEED)
    upload = {n: [] for n in agents}
    for k in list(theirs_k.KERNELS) + list(kernels.KERNELS):
        k.launches = 0
    for t in range(AGENT_WARMUP + AGENT_TICKS):
        obs = sim.observe()
        for n in (list(agents) if t % 2 == 0 else list(agents)[::-1]):
            control = agents[n][0].run_step(obs)
            upload[n].append(agents[n][0].last_phase_ms["upload_infer"])
            if not np.isfinite([control["steer"], control["throttle"], control["brake"]]).all():
                fail(f"agent ({n}) tick {t}: control not finite")
        sim.apply(control)
    a, b = (upload[n][AGENT_WARMUP:] for n in agents)
    diff = [y - x for x, y in zip(a, b)]
    say(f"[compare] AgentCore(stage2_serving_det) fp32 tick on {card}, {AGENT_TICKS} ticks after "
        f"{AGENT_WARMUP}, both agents on each observation, order alternating: upload_infer theirs "
        f"median {statistics.median(a):.2f} ms [{min(a):.2f}, {max(a):.2f}], ours "
        f"{statistics.median(b):.2f} ms [{min(b):.2f}, {max(b):.2f}], ours - theirs per tick "
        f"median {statistics.median(diff):.2f} ms [{min(diff):.2f}, {max(diff):.2f}]; sampler "
        f"kernel launches theirs {_launch_counts(theirs_k)}, ours {_launch_counts(kernels)} "
        f"over {len(a) + AGENT_WARMUP} ticks each")



PROFILE_CALLS = 5
# --profile-routes: the binned plans' counts an item (kernels._BIN_COUNTS_PER_ITEM)
PROFILE_COUNTS_PER_ITEM = (2, 8, 16, 64)


def _k1_profile_bytes(args):
    """K1-bwd's bytes by launch name: (the binned design's, the earlier
    designs')."""
    fm, px, py, wg, gout = args[:5]
    h, w, C = fm.shape[1:]
    _, rows = _k1_reads(px, py, wg, h, w, bwd=True)
    small = _nbytes(px, py, wg, gout)
    samples = rows * C * 4 + small + _nbytes(px) * 2 + _nbytes(wg)
    items = px.numel()
    return ({"samples": samples + items * (4 + 16), "bin_place": items * (4 + 16 + 16),
             "bin_cells": items * 16 + small + _nbytes(fm)},
            {"samples": samples, "tiles": small + _nbytes(fm)})


def _k2_profile_bytes(args):
    """K2-bwd's (or K2-bwd-lk's) bytes by launch name: (the binned
    design's, the earlier designs')."""
    m, c_, xx, yy, ww, gout = args[:6]
    lvl = args[7] if len(args) > 7 else None
    _, map_bytes = _k2_reads(m, c_, xx, yy, ww, True, lvl)
    taps = xx.numel() * ww.shape[2] * 4
    cells = sum(t.numel() // t.shape[-1] for t in m)
    dmaps = _nbytes(*m)
    small = _nbytes(c_, xx, yy, ww, gout) + (0 if lvl is None else _nbytes(lvl))
    rows_k = map_bytes + small + _nbytes(xx, yy, ww)
    return ({"patch_sample_bwd_kernel": rows_k + taps // 4 * (4 + 16),
             "bin_place": taps // 4 * (4 + 16 + 16), "bin_cells": taps // 4 * 16 + small + dmaps},
            {"patch_sample_bwd_kernel": rows_k, "cells": (cells + 1) * 4 + taps * 8 + small + dmaps,
             "sort": taps * (4 + 4 + 8), "search": taps * 4 + (cells + 1) * 8,
             "fillfunctor": [_nbytes(t) for t in m], "arange": (cells + 1) * 4})


def _profile_call(tree, what, name, fn, args, nbytes):
    """``PROFILE_CALLS`` profiled calls of fn(*args) after a warm-up: each
    launch's device time (median) and bytes; returns their total."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    calls = []
    for _ in range(PROFILE_CALLS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        calls.append([(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                      for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA])
    n = min(len(c) for c in calls)
    total = 0.0
    for i in range(n):
        launch = calls[0][i][0]
        ms = statistics.median(c[i][1] for c in calls)
        total += ms
        nb = next((v for k, v in nbytes.items() if k in launch.lower()), None)
        if isinstance(nb, list):  # one entry a launch of that name, in order
            nb = nb[sum(1 for c in calls[0][:i] if c[0] == launch) % len(nb)]
        by = (f", {nb / 1e6:.2f} MB, {nb / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory "
              f"rate ({ms / (nb / HBM_BYTES_PER_S * 1e3):.1f}x)" if nb else "")
        say(f"[profile] {tree} {what} route {name} launch {i}: {ms:.4f} ms{by}: {launch[:110]}")
    say(f"[profile] {tree} {what} route {name}: {n} launches, {total:.4f} ms of device time in "
        f"all")
    return total


def profile_routes(cfg, card: str, kmod, tree: str, step_calls):
    """``--profile-routes``: one call of each design of a tree's backward
    wrappers (``kmod``, its ``ops/kernels.py``: each route where it
    declares them, else its one design, the binned scatter) at phases 3b's
    and 9's shapes (K1-bwd per coarse level, K2-bwd, K2-bwd-lk) and at a
    stage-2 step's own largest calls (``step_calls``: ``step_bwd_calls``);
    fp32, flag off; under torch.profiler, ``PROFILE_CALLS`` calls after a
    warm-up: every launch inside the call (the kernels' own and torch's:
    fills, memsets, sort, arange, searchsorted), its device time (median
    over the calls), and, for the launches named, the bytes it must move
    (each input read once, each output written once) over the card's memory
    rate. The binned design is profiled at each of
    ``PROFILE_COUNTS_PER_ITEM``, its plan printed."""
    import torch

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []  # (what, wrapper name, args, bytes of the binned design, the earlier designs')
    for lvl in [l for l in cfg.sampler_matmul_levels if l < cfg.num_levels]:
        fm, px, py, wg, bs, cams = _k1_bwd_inputs(cfg, g, dev, lvl, torch.float32)
        gout = torch.randn(bs, px.shape[1], fm.shape[-1], generator=g, device=dev)
        args = (fm, px, py, wg, gout, bs, cams)
        cases.append((f"K1-bwd level {lvl} ({fm.shape[1]}x{fm.shape[2]})",
                      "interp_sample_camsum_bwd", args, *_k1_profile_bytes(args)))
    maps, cam, x, y, w, cam_k = _k2_inputs(cfg, g, dev, torch.float32)
    gout = torch.randn(x.shape[0], x.shape[1] // cam_k, maps[0].shape[-1], generator=g,
                       device=dev)
    g2 = torch.Generator(device=dev).manual_seed(SEED + 2)
    lk = _lk_inputs(cfg, g2, dev, torch.float32, True)
    glk = torch.randn(x.shape[0], x.shape[1] // cam_k, maps[0].shape[-1], generator=g2,
                      device=dev)
    for what, name, args in (("K2-bwd", "patch_sample_bwd", (maps, cam, x, y, w, gout, cam_k)),
                             ("K2-bwd-lk", "patch_sample_bwd_lk",
                              lk[:5] + (glk, cam_k, lk[6]))):
        cases.append((what, name, args, *_k2_profile_bytes(args)))
    for what, name, args in step_calls:
        cases.append((what, name, args, *(_k1_profile_bytes(args)
                                           if name == "interp_sample_camsum_bwd"
                                           else _k2_profile_bytes(args))))
    say(f"[profile] {tree}: one call of each design, fp32, torch's deterministic flag off, "
        f"{PROFILE_CALLS} calls profiled after a warm-up, device time per launch (median) on "
        f"{card}; bytes: each input read once and each output written once, at "
        f"{HBM_BYTES_PER_S / 1e12:g} TB/s")
    budget = getattr(kmod, "_BIN_COUNTS_PER_ITEM", None)
    for what, name, args, binned, earlier in cases:
        kernel = getattr(kmod, name)
        for route, fn in _their_routes(kernel):
            if route is not None:
                _profile_call(tree, what, route, fn, args, earlier)
                continue
            for c in ([budget] if budget is None else PROFILE_COUNTS_PER_ITEM):
                if budget is not None:
                    kmod._BIN_COUNTS_PER_ITEM = c
                try:
                    plan = (kmod.k1_bwd_plan(args[0].shape[0], args[0].shape[1], args[0].shape[2],
                                             args[1].shape[1])
                            if name == "interp_sample_camsum_bwd" else
                            kmod.k2_bwd_plan(args[2].shape[0], args[0][0].shape[1],
                                             [m.shape[2:4] for m in args[0]], args[2].shape[1],
                                             args[4].shape[2]))
                    total = _profile_call(tree, what, "binned", fn, args, binned)
                finally:
                    if budget is not None:
                        kmod._BIN_COUNTS_PER_ITEM = budget
                say(f"[profile] {tree} {what} binned at {c} counts an item "
                    f"({'the default' if c == budget else 'swept'}): {_plan_text(plan)}; "
                    f"{total:.4f} ms")


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="time another checkout's kernels and paths against this tree's")
    ap.add_argument("--graphs", action="store_true",
                    help="run [graphs] (the decoder's op runs as CUDA graphs) and stop")
    ap.add_argument("--profile-routes", action="store_true",
                    help="profile one call of each backward route, launch by launch (with "
                         "--against, the other tree's first), and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a CUDA card only")
    if not os.path.isdir(os.path.join(ROOT, "hipad_torch")):
        fail(f"no hipad_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from hipad_torch.configs.model import stage2

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, phase, *a):
        t = time.perf_counter()
        out = phase(*a)
        seconds[name] = time.perf_counter() - t
        return out

    card = timed("env", phase_env)
    timed("build", phase_build)
    cfg = stage2()
    if args.graphs:
        timed("graphs", phase_graphs, card)
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return
    if args.profile_routes:
        from hipad_torch.ops import kernels

        step_calls = step_bwd_calls()
        if args.against:
            profile_routes(cfg, card, _other_tree(args.against)["ops.kernels"], "theirs",
                           step_calls)
        profile_routes(cfg, card, kernels, "ours", step_calls)
        return
    if args.against:
        compare_paths(compare_against(args.against, cfg, card), card)
        return
    k = timed("kernels", phase_kernels, cfg, card)
    k.update(timed("kernels-bwd", phase_kernels_bwd, cfg, card))
    frame_launches = timed("slice", phase_slice, cfg, card)
    timed("graphs", phase_graphs, card)
    step_launches = timed("train", phase_train, card)
    k.update(timed("match", phase_match, card))
    cli_launches, cli_work = timed("train-cli", phase_train_cli, card)
    eval_launches, loader_launches = timed("eval", phase_eval, card, cli_work)
    stage1_launches = timed("stage1", phase_stage1, card)
    ddp_launches = timed("ddp", phase_ddp, card)
    serve_launches, weights = timed("serve", phase_serving, card)
    agent_launches = timed("agent", phase_agent, card, weights)
    del weights
    closed_loop_launches = timed("closed-loop", phase_closed_loop, card)
    gather_recs, probe_launches = timed("gather", phase_gather, card)
    k.update(gather_recs)
    option_recs, option_frames, option_step = timed("options", phase_options, cfg, card)
    k.update(option_recs)
    if any(m in sys.modules for m in ("jax", "flax")):
        fail("jax was imported")
    if any(m.split(".")[0] == "hipad_tpu" for m in sys.modules):
        fail("a module of the JAX package was imported")
    gather_src = "hipad_torch/csrc/row_gather.cu"
    sources = {
        "coarse_sample": ("hipad_torch/csrc/interp_sample.cu",
                          "hipad_tpu/ops/pallas_interp.py:68", "serving_frame"),
        "patch_sample": ("hipad_torch/csrc/patch_sample.cu", "hipad_tpu/ops/sampling.py:494",
                         "serving_frame"),
        "interp_sample_camsum_bwd": ("hipad_torch/csrc/interp_sample_bwd.cu",
                                     "hipad_tpu/ops/sampling.py:252", "step"),
        "patch_sample_bwd": ("hipad_torch/csrc/patch_sample_bwd.cu",
                             "hipad_tpu/ops/sampling.py:530", "step"),
        "gather_rows_f32": (gather_src, "tools/probe_pallas_gather.py:39", "probe"),
        "gather_rows_bf16": (gather_src, "tools/probe_pallas_gather.py:79", "probe"),
        "gather_rows_f32_every8": (gather_src, "tools/probe_pallas_gather.py:133", "probe"),
        "patch_sample_lk": ("hipad_torch/csrc/patch_sample.cu", "hipad_tpu/ops/sampling.py:839",
                            "options_frame"),
        "patch_sample_bwd_lk": ("hipad_torch/csrc/patch_sample_bwd.cu",
                                "hipad_tpu/ops/sampling.py:530", "options_step"),
        "lsa_assign": ("hipad_torch/csrc/lsa_assign.cu", "hipad_tpu/targets/matching.py:36",
                       "step"),
    }
    paths = {
        "step": (step_launches, f"phase 5: {WARMUP_STEPS + TIMED_STEPS} chained stage-2 fp32 "
                                "training steps"),
        "train_cli": (cli_launches, f"phase 5b: python -m hipad_torch.tools.train --synthetic "
                                    f"{CLI_STEPS} --accum-steps {CLI_ACCUM}, unbroken"),
        "eval": (eval_launches, f"phase 5e: python -m hipad_torch.tools.test, {EVAL_FRAMES} "
                                "stage-2 bf16 frames streaming"),
        "train_loader": (loader_launches, f"phase 5e: python -m hipad_torch.tools.train "
                                          f"--ann-file, {LOADER_STEPS} steps and "
                                          f"{LOADER_EVAL_FRAMES} eval frames"),
        "stage1_step": (stage1_launches, "phase 5c: one stage1() training step"),
        "ddp": (ddp_launches, "phase 5d: 2 gloo ranks x one stage-2 step at bs=1"),
        "frame": (frame_launches, f"phase 4: {WARMUP_FRAMES + TIMED_FRAMES} chained stage-2 "
                                  "fp32 frames"),
        "serving_frame": (serve_launches, f"phase 6: {WARMUP_FRAMES + TIMED_FRAMES} chained "
                                          "stage2_serving_det fp32 frames"),
        "agent": (agent_launches, f"phase 7: {AGENT_WARMUP + AGENT_TICKS} AgentCore ticks"),
        "closed_loop": (closed_loop_launches, f"phase 7b: {CL_TICKS} HiPADTorchAgent ticks, "
                                              f"{CL_BENCH_TICKS} serving-bench ticks and the "
                                              "error sweep's rows"),
        "probe": (probe_launches, "phase 8: python -m hipad_torch.tools.probe_gather <probe> "
                                  "time"),
        "options_frame": (option_frames, f"phase 9: {WARMUP_FRAMES + TIMED_FRAMES} chained fp32 "
                                         "frames of stage2_serving with the level top-k, the "
                                         "attention masks and the per-point embeds (frame A)"),
        "options_step": (option_step[0], "phase 9: one fp32 training step of frame A's config"),
        "options_step_flag": (option_step[1], "phase 9: the same step under "
                                              "torch.use_deterministic_algorithms(True)"),
    }
    rows = []
    for name, (src, rep, own) in sources.items():
        by_path = {p: c[name] for p, (c, _) in paths.items() if c.get(name)}
        if not by_path.get(own):
            fail(f"{name} was not launched on its path ({paths[own][1]})")
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": by_path[own], "launches_of": paths[own][1],
                     "launches_by_path": by_path, "max_abs_err": k[name].err,
                     "ms": k[name].ms, "per_call_ms": k[name].per_call_ms,
                     "plain_ms": k[name].plain_ms,
                     "bound_ms": k[name].bound_ms, "bound_by": k[name].bound_by,
                     "library_ms": k[name].library_ms})
    say(json.dumps({"kernels": rows}))
    say(f"[done] {time.perf_counter() - t0:.1f} s; per phase: "
        + ", ".join(f"{n} {t:.1f} s" for n, t in seconds.items()))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
