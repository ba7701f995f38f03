#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure exits non-zero:

  1. environment: torch/CUDA versions and the card's name and power limit
     (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
  2. build the sampler kernels from ``hipad_torch/csrc/*.cu`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     stage-2 shapes the main path gives it, fp32 and bf16 feature maps;
  4. the main path: ``stage2()`` with seeded random weights, bs=1, 2 warm-up
     and 8 timed frames with the banks chained and a new image per frame, in
     fp32 and then under bf16 autocast; finite outputs; every kernel's launch
     count over those frames; then frame 1 once more on the CPU (plain path,
     fp32) against the card's fp32 frame 1.

The line before the last is a JSON object with one entry per kernel; the last
is ``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
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
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")


def _max_err(got, ref):
    return float((got - ref).abs().max()), float(ref.abs().max())


def phase_kernels(cfg, card: str):
    """K1 on levels 2-3 (all 6 cameras), K2 on levels 0-1 (cam_k slots), at
    the det task's sample count, against the plain versions."""
    import torch

    from hipad_torch.ops import kernels, sampling

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    bs, cams, C, G = 1, cfg.num_cams, cfg.embed_dims, cfg.num_groups
    H, W = cfg.input_size
    dims = [(H // s, W // s) for s in cfg.strides]
    n_pts = len(cfg.det_kps.fix_scale) + cfg.det_kps.num_learnable
    M0 = cfg.num_det_anchor * n_pts
    cam_k = cfg.sampler_cam_k
    fine = [l for l in range(cfg.num_levels) if l not in cfg.sampler_matmul_levels]
    coarse = [l for l in cfg.sampler_matmul_levels if l < cfg.num_levels]
    results = {}

    def sparse_weights(shape, keep):
        w = torch.rand(shape, generator=g, device=dev)
        return w * (torch.rand(shape[:-1], generator=g, device=dev) < keep)[..., None]

    # ---- K1 -------------------------------------------------------------
    k1 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for lvl in coarse:
            h, w = dims[lvl]
            fm = torch.randn(bs * cams, h, w, C, generator=g, device=dev).to(dtype)
            px = torch.rand(bs * cams, M0, generator=g, device=dev) * (w + 2) - 1.5
            py = torch.rand(bs * cams, M0, generator=g, device=dev) * (h + 2) - 1.5
            wg = sparse_weights((bs * cams, M0, G), keep=0.4)
            got = kernels.interp_sample_camsum(fm, px, py, wg, bs, cams)
            ref = sampling.interp_matmul_camsum(fm, px, py, wg, bs, cams)
            torch.cuda.synchronize()
            err, scale = _max_err(got, ref)
            ok = err <= KERNEL_RTOL * scale
            say(f"[kernels] K1 interp_sample_camsum level {lvl} ({h}x{w}) {str(dtype)[6:]} "
                f"B={bs * cams} M={M0} C={C}: max_abs_err {err:.3e} (tol {KERNEL_RTOL:g} x "
                f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"K1 disagrees with its plain version at level {lvl}, {dtype}")
            k1["err"] = max(k1["err"], err)
            if dtype == torch.float32:
                t = [cuda_time_ms(f, 20) for f in (
                    lambda: sampling.interp_matmul_camsum(fm, px, py, wg, bs, cams),
                    lambda: kernels.interp_sample_camsum(fm, px, py, wg, bs, cams),
                    lambda: kernels.interp_sample_camsum(fm, px, py, wg, bs, cams),
                    lambda: sampling.interp_matmul_camsum(fm, px, py, wg, bs, cams))]
                k1["ms"] += min(t[1], t[2])
                k1["plain_ms"] += min(t[0], t[3])
                say(f"[kernels] K1 level {lvl} fp32 on {card}: kernel {min(t[1], t[2]):.4f} ms, "
                    f"plain {min(t[0], t[3]):.4f} ms (median of 20, plain/kernel/kernel/plain)")
    results["interp_sample_camsum"] = k1

    # ---- K2 -------------------------------------------------------------
    k2 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    M = M0 * cam_k
    cam = torch.randint(0, cams, (bs, M), generator=g, device=dev, dtype=torch.int32)
    x = torch.rand(bs, M, generator=g, device=dev) * 1.2 - 0.1
    y = torch.rand(bs, M, generator=g, device=dev) * 1.2 - 0.1
    inside = ((x > 0) & (x < 1) & (y > 0) & (y < 1)).float()
    w = sparse_weights((bs, M, len(fine), G), keep=0.7) * inside[..., None, None]
    for dtype in (torch.float32, torch.bfloat16):
        maps = [torch.randn(bs, cams, *dims[l], C, generator=g, device=dev).to(dtype)
                for l in fine]
        got = kernels.patch_sample(maps, cam, x, y, w, cam_k)
        ref = sampling.patch_sample_plain(maps, cam, x, y, w, cam_k)
        torch.cuda.synchronize()
        err, scale = _max_err(got, ref)
        ok = err <= KERNEL_RTOL * scale
        say(f"[kernels] K2 patch_sample levels {fine} {str(dtype)[6:]} bs={bs} M0={M0} "
            f"cam_k={cam_k} C={C}: max_abs_err {err:.3e} (tol {KERNEL_RTOL:g} x {scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K2 disagrees with its plain version, {dtype}")
        k2["err"] = max(k2["err"], err)
        if dtype == torch.float32:
            t = [cuda_time_ms(f, 20) for f in (
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k),
                lambda: kernels.patch_sample(maps, cam, x, y, w, cam_k),
                lambda: kernels.patch_sample(maps, cam, x, y, w, cam_k),
                lambda: sampling.patch_sample_plain(maps, cam, x, y, w, cam_k))]
            k2["ms"], k2["plain_ms"] = min(t[1], t[2]), min(t[0], t[3])
            say(f"[kernels] K2 fp32 on {card}: kernel {k2['ms']:.4f} ms, plain "
                f"{k2['plain_ms']:.4f} ms (median of 20, plain/kernel/kernel/plain)")
    results["patch_sample"] = k2
    return results


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

    from hipad_tpu.data import synthetic
    from hipad_torch.models.detector import HiPAD, batch_to_torch
    from hipad_torch.ops import kernels
    from hipad_torch.weights import init_random

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = init_random(HiPAD(cfg, device=dev), SEED)
    images, metas = batch_to_torch(synthetic.make_batch(cfg, 1, seed=SEED), dev)
    say(f"[slice] stage2 built with seeded weights on the card in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters")

    n_deform = cfg.operation_order.count("deformable") * len(cfg.query_select)
    per_call = {
        "interp_sample_camsum": len([l for l in cfg.sampler_matmul_levels if l < cfg.num_levels]),
        "patch_sample": int(any(l not in cfg.sampler_matmul_levels
                                for l in range(cfg.num_levels))),
    }
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
        banks, times, first = None, [], None
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
                if i == 0:
                    first = {k: v.detach().clone() for k, v in leaves}
        launches = {k.name: k.launches for k in kernels.KERNELS}
        timed = sorted(times[WARMUP_FRAMES:])
        p90 = timed[min(len(timed) - 1, int(round(0.9 * (len(timed) - 1))))]
        say(f"[slice] stage2 bs=1 {str(dtype)[6:]} on {card}: {n_frames} chained frames finite; "
            f"per frame median {statistics.median(timed):.2f} ms, p90 {p90:.2f} ms "
            f"(host clock, sync per frame, frames {WARMUP_FRAMES}..{n_frames - 1}); "
            f"frame 0 {times[0]:.1f} ms")
        for name, n in launches.items():
            want = n_frames * n_deform * per_call[name]
            say(f"[slice] {str(dtype)[6:]} {name}: {n} launches over {n_frames} frames = "
                f"{n / n_frames:g}/frame (expected {n_deform} deformable calls x "
                f"{per_call[name]} = {n_deform * per_call[name]}/frame)")
            if n != want or n == 0:
                fail(f"{name} launched {n} times, expected {want}")
        return first, launches

    first, launches = run_frames(torch.float32)
    first_bf16, _ = run_frames(torch.bfloat16)
    wp = "plan.final_waypoints"
    say(f"[slice] bf16 vs fp32 frame 0 {wp}: max_abs_diff "
        f"{float((first_bf16[wp].float() - first[wp]).abs().max()):.3e} "
        f"(scale {float(first[wp].abs().max()):.3e}; informational)")

    # frame 1 again on the CPU: the plain path
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on a CUDA card only")
    if not os.path.isdir(os.path.join(ROOT, "hipad_torch")):
        fail(f"no hipad_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    from hipad_tpu.configs.model import stage2

    card = phase_env()
    phase_build()
    cfg = stage2()
    k = phase_kernels(cfg, card)
    launches = phase_slice(cfg, card)
    if any(m in sys.modules for m in ("jax", "flax")):
        fail("jax was imported")
    sources = {
        "interp_sample_camsum": ("hipad_torch/csrc/interp_sample.cu",
                                 "hipad_tpu/ops/pallas_interp.py:68"),
        "patch_sample": ("hipad_torch/csrc/patch_sample.cu", "hipad_tpu/ops/sampling.py:494"),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": k[name]["err"],
         "ms": k[name]["ms"], "plain_ms": k[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
