"""Open-loop evaluation CLI (counterpart of ``tools/test.py``).

    python -m hipad_torch.tools.test --ann-file data/infos/b2d_infos_val.pkl \\
        --map-file data/infos/b2d_map_infos.pkl --ckpt work_dirs/hipad_torch \\
        --eval-det --eval-map --eval-motion [--batch-slots 2 --num-workers 2]

It streams the val split in sequence order (the temporal banks carry from
frame to frame) on the card (``--device cuda``, the default; ``--device
cpu`` for tests) under bf16 autocast, as the JAX CLI does, decodes each
frame, and prints planning L2 and collision, detection mAP/NDS, map
chamfer-AP and motion EPA as the reference's tables, then one JSON object
of the summary and ``perf``. ``--batch-slots B`` streams B sequences per
forward (``eval.runner``).

``--ckpt`` is a work dir of ``python -m hipad_torch.tools.train``: the
parameters and buffers of its latest step. Without it the weights are
seeded random. Several processes (``WORLD_SIZE`` of them, each with its
``RANK``, as ``torchrun`` sets them) each evaluate a sequence-aligned shard
and write their records to ``--gather-dir``; rank 0 merges and reports.

Before the tables, a line says how many camera files of the evaluated
frames exist (an absent file loads as zeros) and one gives, per motion
class, the matched agents that minADE, minFDE and MR average over (they
read 0.0 when none matched). ``perf.frames`` counts the frames evaluated;
``perf.load_s`` is the host time rank 0 spent waiting on the dataset,
``perf.forward_s`` in its forwards (with the decode and the copy of the
results to the host); the rest of ``wall_s`` is the per-frame metrics and
the summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from ..configs import model as cfgs
from ..data.bench2drive import Bench2DriveDataset
from ..eval import runner
from ..eval.report import format_summary
from ..models.detector import HiPAD
from ..train import checkpoint
from ..weights import init_random

# ``--tiny`` at the dataset's shapes: six cameras, six future steps, map
# lines of 20 points, and the plan anchor types the collector reads
# (``plan_temp_2hz``)
TINY_DATASET = dict(
    num_cams=6, input_size=(64, 96), ego_fut_ts=6, fut_ts=6, map_num_pts=20,
    map_kps=cfgs.PointKeypointSpec(20, 2, (0.0, 0.5), cfgs.GROUND_HEIGHT),
    plan_kps=cfgs.PointKeypointSpec(6, 2, (0.0, 0.5), cfgs.GROUND_HEIGHT),
    plan_anchor_types=(("temp", "2hz"), ("spat", "2m"), ("speed", "2hz", (0.0, 3.0)),
                       ("speed", "2hz", (3.0, 999.0))),
    plan_anchor_refer=("spat", "2m"), plan_speed_refer=("temp", "2hz"),
)


def config(stage: int, tiny: bool):
    if tiny:
        return cfgs.tiny(**TINY_DATASET)
    return cfgs.stage2() if stage == 2 else cfgs.stage1()


def open_dataset(cfg, ann_file: str, map_file: Optional[str], data_root: str,
                 test_mode: bool) -> Bench2DriveDataset:
    return Bench2DriveDataset(ann_file=ann_file, map_file=map_file, data_root=data_root,
                              test_mode=test_mode, plan_anchor_types=cfg.plan_anchor_types,
                              data_aug_conf=cfgs.aug_conf_for(cfg.input_size))


def camera_files(dataset: Bench2DriveDataset, n: int) -> Dict[str, int]:
    """Of the camera files of frames ``[0, n)``: how many exist, and how
    many are absent (the dataset loads those as zeros)."""
    paths = [p for i in range(n) for p in dataset.get_data_info(i)["img_filename"]]
    found = sum(os.path.exists(p) for p in paths)
    return {"found": found, "absent": len(paths) - found}


def device_for(name: str, rank: int) -> torch.device:
    """``cuda`` (the card ``LOCAL_RANK`` or ``rank`` names; raises without
    one) or ``cpu``."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass --device cpu to "
                         "run on the CPU)")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                          % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m hipad_torch.tools.test",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--ann-file", required=True)
    p.add_argument("--map-file", default=None)
    p.add_argument("--data-root", default="data/bench2drive")
    p.add_argument("--ckpt", default=None,
                   help="work dir of python -m hipad_torch.tools.train (its latest step)")
    p.add_argument("--stage", type=int, default=2, choices=[1, 2])
    p.add_argument("--tiny", action="store_true", help="tiny config at the dataset's shapes (CI)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--out", default=None, help="json results path")
    p.add_argument("--eval-planning", action="store_true", default=True)
    p.add_argument("--eval-det", action="store_true")
    p.add_argument("--eval-map", action="store_true")
    p.add_argument("--eval-motion", action="store_true")
    p.add_argument("--batch-slots", type=int, default=1,
                   help="stream N independent sequences per forward")
    p.add_argument("--num-workers", type=int, default=0,
                   help="data-loading threads for the batched runner")
    p.add_argument("--gather-dir", default="work_dirs/eval_gather",
                   help="rank-ordered pickle gather dir (WORLD_SIZE > 1)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (one card per process) unless told cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the CLI -> ``{"summary" (None on ranks other than 0), "perf",
    "records" (the runner's, merged on rank 0), "cameras"}``."""
    args = parse_args(argv)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    device = device_for(args.device, rank)
    cfg = config(args.stage, args.tiny)
    model = HiPAD(cfg, device=device)
    if args.ckpt:
        skipped = checkpoint.load_params_only(args.ckpt, model)
        if skipped:
            print(f"{args.ckpt}: not loaded: {skipped}", flush=True)
    else:
        init_random(model, 0)
    dataset = open_dataset(cfg, args.ann_file, args.map_file, args.data_root, test_mode=True)
    n = len(dataset) if args.max_frames is None else min(args.max_frames, len(dataset))
    cameras = camera_files(dataset, n)

    t0 = time.perf_counter()
    records = runner.collect_records(
        model, dataset, max_frames=args.max_frames, dtype=torch.bfloat16,
        eval_planning=args.eval_planning, eval_det=args.eval_det, eval_map=args.eval_map,
        eval_motion=args.eval_motion, batch_slots=args.batch_slots, rank=rank, world=world,
        num_workers=args.num_workers)
    # this rank's, before the gather extends the lists
    load_s, forward_s = sum(records["load_s"]), sum(records["forward_s"])
    merged = runner.gather_records(records, rank, world, args.gather_dir)
    if merged is None:  # rank != 0: its records went to rank 0
        return {"summary": None, "perf": None, "records": records, "cameras": cameras}
    summary = runner.summarize(merged)
    wall = time.perf_counter() - t0

    print(f"cameras: {cameras['found']} of {cameras['found'] + cameras['absent']} files of "
          f"the {n} frames found; {cameras['absent']} absent, loaded as zeros", flush=True)
    if "motion" in summary:
        matches = {k[:-len("_matches")]: v for k, v in summary["motion"].items()
                   if k.endswith("_matches")}
        print(f"motion: matched agents with a valid future, which minADE, minFDE and MR "
              f"average over (0.0 when none matched): {matches}", flush=True)
    tables = format_summary(summary)
    if tables:
        print(tables)
        print()
    frames = len(merged["frames"])
    # wall includes the first frames' warm-up: fps_wall is this invocation's
    # end-to-end rate over the frames it evaluated, not a steady-state rate
    perf = {"frames": frames, "wall_s": round(wall, 3), "fps_wall": round(frames / wall, 3),
            "load_s": round(load_s, 3), "load_share": round(load_s / wall, 4),
            "forward_s": round(forward_s, 3), "forward_share": round(forward_s / wall, 4)}
    print(json.dumps({**summary, "perf": perf}, indent=2, default=float), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "perf": perf}, f, default=float)
    return {"summary": summary, "perf": perf, "records": merged, "cameras": cameras}


if __name__ == "__main__":
    main(sys.argv[1:])
