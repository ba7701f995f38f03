"""The closed-loop agent's serving loop on the port, end to end (counterpart
of ``tools/closed_loop_serving_bench.py``).

Runs the scripted replay (``agent/replay.py:run_scripted_replay``) with the
serving configuration (``stage2_serving`` or another factory, with
overrides): seeded random weights, bf16, collision rescore on, the x10
closed-loop bank round robin, JPEG-compressed synthetic 1600x900 cameras and
the native resize/crop, for ``--ticks`` ticks, and records each tick's wall
latency, its phases (host preprocessing, upload and inference) and its
controls. It measures the agent loop (preprocessing, streaming inference,
plan decode, PID), not the bare model: the closest stand-in for a CARLA
leaderboard run (20 Hz ticks) without a simulator.

Writes one JSONL line per tick to ``--out`` (under ``work_dirs/`` by
default) and prints a one-line JSON summary. The model runs on the card
unless ``--device cpu``.

    python -m hipad_torch.tools.closed_loop_serving_bench [--ticks 120] \\
        [--config stage2_serving] [--set k=v ...] [--out PATH]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import pathlib
import time
from typing import Dict, Optional, Sequence

DEFAULT_OUT = (pathlib.Path(__file__).resolve().parents[2] / "work_dirs"
               / "closed_loop_serving.jsonl")
SEED = 0


def _overrides(pairs: Sequence[str]) -> Dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--config", default="stage2_serving")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=python_literal")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..agent.calib import CAMERAS, IMG_H, IMG_W
    from ..agent.core import AgentCore
    from ..agent.replay import run_scripted_replay, scripted_route
    from ..configs import model as config_lib
    from ..models.detector import HiPAD
    from ..weights import init_random

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("closed_loop_serving_bench: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    overrides = _overrides(args.set)
    cfg = getattr(config_lib, args.config)(**overrides)
    weights = init_random(HiPAD(cfg, device=args.device), SEED).state_dict()
    # the serving agent: bf16, rescore on, x10 banks, the JPEG input path
    agent = AgentCore(cfg, weights, dtype=torch.bfloat16, jpeg_quality=20, with_rescore=True,
                      device=args.device)
    del weights
    route = scripted_route()

    # a pool of synthetic camera frames: rendering is the simulator's work
    # (CARLA renders in its own process), so it is not billed to the agent
    rng = np.random.RandomState(SEED)
    pool = [{cam: rng.randint(0, 255, (IMG_H, IMG_W, 3), np.uint8) for cam in CAMERAS}
            for _ in range(8)]

    ticks, phases = [], []

    def on_tick(t, ag):
        ticks.append(time.perf_counter())
        phases.append(dict(ag.last_phase_ms))

    t_start = time.perf_counter()
    log = run_scripted_replay(agent, route, n_ticks=args.ticks, speed=5.0,
                              img_hw=(IMG_H, IMG_W), on_tick=on_tick,
                              images_fn=lambda t: pool[t % len(pool)])
    wall = time.perf_counter() - t_start

    # tick i's latency is the time since the tick before; each bank slot's
    # first visit starts cold, so the first n_banks + 1 ticks are warm-up
    lat = np.diff(np.asarray([t_start] + ticks))
    warm = lat[len(agent.banks) + 1:]

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for i, (entry, dt, ph) in enumerate(zip(log, lat, phases)):
            f.write(json.dumps({
                "tick": i,
                "latency_ms": round(float(dt) * 1e3, 2),
                **{k: round(v, 2) for k, v in ph.items()},
                "steer": round(float(entry["steer"]), 4),
                "throttle": round(float(entry["throttle"]), 4),
                "brake": round(float(entry["brake"]), 4),
                "command": entry["command"],
                "route_len": entry["route_len"],
            }) + "\n")

    steers = np.asarray([e["steer"] for e in log])
    thr = np.asarray([e["throttle"] for e in log])
    brk = np.asarray([e["brake"] for e in log])
    sane = bool(np.isfinite(steers).all() and (np.abs(steers) <= 1).all()
                and (thr >= 0).all() and (thr <= 1).all()
                and (brk >= 0).all() and (brk <= 1).all())
    warm_ph = phases[len(agent.banks) + 1:]
    phase_med = {f"{k}_ms_median": round(float(np.median([p[k] for p in warm_ph])), 1)
                 for k in (warm_ph[0] if warm_ph else {})}
    summary = {
        "config": args.config, "overrides": overrides, "ticks": len(log),
        "device": torch.cuda.get_device_name() if args.device == "cuda" else "cpu",
        "warm_ticks": int(len(warm)),
        "tick_ms_median": round(float(np.median(warm)) * 1e3, 1) if len(warm) else None,
        "tick_ms_p90": round(float(np.percentile(warm, 90)) * 1e3, 1) if len(warm) else None,
        "ticks_per_s_warm": round(1.0 / float(np.median(warm)), 2) if len(warm) else None,
        **phase_med,
        "wall_s_total": round(wall, 1),
        "controls_sane": sane,
        # the port's cameras take the native resize/crop unless the
        # augmentation rotates (the pool's cameras share one size)
        "native_preproc": not agent.aug.get("rotate"),
        "commands_seen": sorted({e["command"] for e in log}),
        "out": os.path.relpath(out),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
