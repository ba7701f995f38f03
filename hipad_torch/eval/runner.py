"""Open-loop evaluation runner (counterpart of ``hipad_tpu/eval/runner.py``),
shared by ``python -m hipad_torch.tools.test`` and the training CLI's
``--eval-interval``.

The model is the port's ``HiPAD`` in eval mode on its own device; each
forward runs under ``torch.inference_mode()``, under bf16 autocast when
``dtype`` is ``torch.bfloat16``, and its outputs are decoded in fp32 by
``postprocess.post_process_arrays``. Three execution shapes, all producing
the same per-frame records:

  * **streaming** (``batch_slots=1``): one frame per forward, banks carried
    in dataset order and reset (``None``) at each sequence's first frame.
  * **batched** (``batch_slots=B``): B sequences stream side by side. Each
    sequence's first frame runs at bs=1 with ``banks=None`` (the
    reference's first-frame semantics) and its banks are scattered into
    that slot; every later frame rides one bs=B forward, whose new banks
    are merged with the old under the live-slot mask.
  * **multi-rank** (``world > 1``): each rank evaluates a contiguous,
    sequence-aligned shard, writes its records as a pickle to
    ``gather_dir``, and rank 0 merges them in rank order (no collective).

The scheduling, the per-frame records and the summary are the JAX
package's own numpy code, copied; the summary adds, per motion class, the
matched agents its minADE, minFDE and MR average over
(:func:`motion_matches`).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import postprocess
from ..models.common import to_float32
from ..models.detector import META_KEYS
from ..models.instance_bank import map_banks
from .motion import MATCH_DIST


# --------------------------------------------------------------------------
# Sequence scheduling
# --------------------------------------------------------------------------

def sequence_spans(flags, n: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) spans of equal sequence flag within [0, n)."""
    flags = np.asarray(flags)[:n]
    spans = []
    s = 0
    for i in range(1, n + 1):
        if i == n or flags[i] != flags[s]:
            spans.append((s, i))
            s = i
    return spans


def rank_spans(spans, rank: int, world: int) -> List[Tuple[int, int]]:
    """Contiguous per-rank shard, sequence-aligned, balanced by frame count.

    A sequence belongs to the rank whose ideal frame range contains its start
    index — every sequence lands on exactly one rank, shards stay contiguous
    and in order (the gather concatenates them back into dataset order).
    """
    if not spans:
        return []
    total = spans[-1][1]
    lo = round(total * rank / world)
    hi = round(total * (rank + 1) / world)
    return [sp for sp in spans if lo <= sp[0] < hi]


def _assign_slots(spans, batch_slots: int) -> List[List[int]]:
    """Greedy balanced assignment of sequences to slots (dataset order kept
    within a slot)."""
    slots: List[List[int]] = [[] for _ in range(batch_slots)]
    load = [0] * batch_slots
    for s, e in spans:
        k = int(np.argmin(load))
        slots[k].append((s, e))
        load[k] += e - s
    return slots


# --------------------------------------------------------------------------
# Per-frame record collection (identical across execution shapes)
# --------------------------------------------------------------------------

class _Collector:
    def __init__(self, eval_planning, eval_det, eval_map, eval_motion,
                 metric=None):
        from . import planning as plan_eval

        self.eval_planning = eval_planning
        self.eval_det = eval_det
        self.eval_map = eval_map
        self.eval_motion = eval_motion
        self.metric = metric or plan_eval.PlanningMetric()
        self.acc: Dict[str, List] = {
            "planning": [], "det_gt": [], "det_pred": [],
            "map_gt": [], "map_pred": [], "mot_gt": [], "mot_pred": [],
        }

    def collect(self, idx: int, frame: Dict, res: Dict):
        from . import planning as plan_eval

        if self.eval_planning and "plan_temp_2hz" in res:
            boxes = frame["gt_bboxes_3d"][frame["gt_valid"]].copy()
            tmp = boxes[:, 3].copy()
            boxes[:, 3] = boxes[:, 4]
            boxes[:, 4] = tmp
            boxes[:, 6] = -boxes[:, 6] - np.pi / 2
            feats = frame["gt_attr_labels"][frame["gt_valid"]]
            gt_traj = np.cumsum(frame["gt_ego_fut_trajs_2hz"], axis=0)
            valid = bool((frame["gt_ego_fut_masks_2hz"] == 1).all())
            self.acc["planning"].append((idx, plan_eval.compute_planner_metric_stp3(
                self.metric, np.asarray(res["plan_temp_2hz"]), gt_traj, boxes,
                feats, valid,
            )))
        det_gt_entry = None
        if self.eval_det or self.eval_motion:
            from ..configs.model import DET_CLASS_NAMES

            names = np.asarray(DET_CLASS_NAMES)
            v = frame["gt_valid"]
            det_gt_entry = {"boxes": frame["gt_bboxes_3d"][v],
                            "names": names[frame["gt_labels_3d"][v]]}
            det_pred_entry = {
                "boxes": np.asarray(res["boxes_3d"])[:, :9],
                "names": names[np.asarray(res["labels_3d"])],
                "scores": np.asarray(res["scores_3d"]),
            }
            self.acc["det_gt"].append((idx, det_gt_entry))
            self.acc["det_pred"].append((idx, det_pred_entry))
        if self.eval_map and "vectors" in res:
            v = frame["gt_map_valid"]
            # GT permutation slot 0 is the canonical ordering
            self.acc["map_gt"].append((idx, {
                "vectors": [p for p in frame["gt_map_pts"][v][:, 0]],
                "labels": frame["gt_map_labels"][v],
            }))
            self.acc["map_pred"].append((idx, {
                "vectors": np.asarray(res["vectors"]),
                "labels": np.asarray(res["labels"]),
                "scores": np.asarray(res["scores"]),
            }))
        if self.eval_motion and "trajs_3d" in res:
            v = frame["gt_valid"]
            gt_cum = (np.cumsum(frame["gt_agent_fut_trajs"][v], axis=1)
                      + frame["gt_bboxes_3d"][v][:, None, :2])
            self.acc["mot_gt"].append((idx, {
                "boxes": frame["gt_bboxes_3d"][v][:, :2],
                "names": det_gt_entry["names"],
                "fut_trajs": gt_cum,
                "fut_masks": frame["gt_agent_fut_masks"][v],
            }))
            self.acc["mot_pred"].append((idx, {
                "boxes": det_pred_entry["boxes"][:, :2],
                "names": det_pred_entry["names"],
                "scores": det_pred_entry["scores"],
                "trajs": np.asarray(res["trajs_3d"]),
                "traj_scores": np.asarray(res["trajs_score"]),
            }))


def _summarize(acc: Dict[str, List]) -> Dict[str, Dict[str, float]]:
    from . import planning as plan_eval

    def ordered(key):
        return [v for _, v in sorted(acc[key], key=lambda t: t[0])]

    summary: Dict[str, Dict[str, float]] = {}
    per_frame = ordered("planning")
    if per_frame:
        summary["planning"] = plan_eval.aggregate_planning_metrics(per_frame)
    det_gt, det_pred = ordered("det_gt"), ordered("det_pred")
    if det_gt and acc.get("_eval_det"):
        from .detection import evaluate_detection

        summary["detection"] = evaluate_detection(det_gt, det_pred)
    map_gt, map_pred = ordered("map_gt"), ordered("map_pred")
    if map_gt:
        from .map import evaluate_map

        summary["map"] = evaluate_map(map_gt, map_pred)
    mot_gt, mot_pred = ordered("mot_gt"), ordered("mot_pred")
    if mot_gt:
        from .motion import evaluate_motion

        summary["motion"] = evaluate_motion(mot_gt, mot_pred)
    return summary


# --------------------------------------------------------------------------
# The port's additions: the motion match count, the model half, the gather
# --------------------------------------------------------------------------

def motion_matches(gt_by_frame: List[Dict], pred_by_frame: List[Dict],
                   class_names=("car", "pedestrian"),
                   score_threshold: float = 0.2) -> Dict[str, int]:
    """Per class with GT, the GT agents matched with a valid future: the
    count ``motion.evaluate_motion`` averages minADE, minFDE and MR over
    (they read 0.0 when it is 0). The same greedy centre-distance match,
    highest score first."""
    out = {}
    for cls in class_names:
        n_gt = n_matched = 0
        for g, p in zip(gt_by_frame, pred_by_frame):
            gsel = np.where(g["names"] == cls)[0]
            n_gt += len(gsel)
            psel = np.where((p["names"] == cls) & (p["scores"] >= score_threshold))[0]
            taken = set()
            for pi in sorted(psel, key=lambda i: -p["scores"][i]):
                best_d, best_j = np.inf, None
                for j in gsel:
                    if j in taken:
                        continue
                    d = np.linalg.norm(g["boxes"][j][:2] - p["boxes"][pi][:2])
                    if d < best_d:
                        best_d, best_j = d, j
                if best_j is None or best_d >= MATCH_DIST:
                    continue
                taken.add(best_j)
                n_matched += int(g["fut_masks"][best_j].astype(bool).any())
        if n_gt:
            out[f"{cls}_matches"] = n_matched
    return out


def summarize(acc: Dict[str, List]) -> Dict[str, Dict[str, float]]:
    """``_summarize``, with the motion match count beside minADE, minFDE
    and MR (``{cls}_matches``)."""
    summary = _summarize(acc)
    if "motion" in summary:
        def ordered(key):
            return [v for _, v in sorted(acc[key], key=lambda t: t[0])]

        summary["motion"].update(motion_matches(ordered("mot_gt"), ordered("mot_pred")))
    return summary


def _metas(frames: List[Dict], device) -> Dict[str, torch.Tensor]:
    """The forward's metadata, stacked over frames (float32 from the
    dataset)."""
    return {k: torch.as_tensor(np.stack([np.asarray(f[k]) for f in frames]), device=device)
            for k in META_KEYS if k in frames[0]}


def collect_records(
    model,
    dataset,
    max_frames: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    eval_planning: bool = True,
    eval_det: bool = False,
    eval_map: bool = False,
    eval_motion: bool = False,
    batch_slots: int = 1,
    rank: int = 0,
    world: int = 1,
    num_workers: int = 0,
) -> Dict[str, List]:
    """Run this rank's frames -> its records: the collector's per-frame
    lists of ``(frame index, entry)``, ``"frames"`` (the indices evaluated),
    ``"load_s"`` (host seconds this thread waited on the dataset) and
    ``"forward_s"`` (host seconds per forward, decode and copy to the
    host)."""
    cfg = model.cfg
    device = next(model.parameters()).device
    bf16 = dtype == torch.bfloat16
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")

    def step(frames, banks, live=None):
        t = time.perf_counter()
        images = torch.as_tensor(np.stack([f["images"] for f in frames]), device=device)
        metas = _metas(frames, device)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            outputs, new_banks = model(images, metas, banks)
        decoded = postprocess.post_process_arrays(cfg, to_float32(outputs),
                                                  metas["gt_ego_fut_cmd"])
        if live is not None:
            new_banks = map_banks(
                lambda n, o: torch.where(live.view((-1,) + (1,) * (n.ndim - 1)), n, o),
                new_banks, banks)
        results = postprocess.to_result_dicts(decoded)  # waits for the forward
        forward_s.append(time.perf_counter() - t)
        return results, new_banks

    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    spans = sequence_spans(dataset.flag, n)
    my_spans = rank_spans(spans, rank, world) if world > 1 else spans

    col = _Collector(eval_planning, eval_det, eval_map, eval_motion)
    frames_done: List[int] = []
    load_s: List[float] = []
    forward_s: List[float] = []

    def load(idxs, pool=None):
        t = time.perf_counter()
        reqs = [{"idx": i, "aug_config": None} for i in idxs]
        out = list(pool.map(dataset.__getitem__, reqs)) if pool else [dataset[r] for r in reqs]
        load_s.append(time.perf_counter() - t)
        return out

    def collect(idx, frame, res):
        col.collect(idx, frame, res)
        frames_done.append(idx)

    def run_first(idx):
        """Sequence-initial frame: bs=1, banks=None."""
        frame = load([idx])[0]
        results, banks1 = step([frame], None)
        collect(idx, frame, results[0])
        return banks1

    was_training = model.training
    model.eval()
    pool = None
    try:
        with torch.inference_mode():
            if batch_slots <= 1:
                for s, e in my_spans:
                    banks = run_first(s)
                    for i in range(s + 1, e):
                        frame = load([i])[0]
                        results, banks = step([frame], banks)
                        collect(i, frame, results[0])
            else:
                B = batch_slots
                slots = _assign_slots(my_spans, B)
                streams = [[(i, i == s) for s, e in sl for i in range(s, e)] for sl in slots]
                ptr = [0] * B
                banks_b = None
                if num_workers > 0:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = ThreadPoolExecutor(num_workers)
                while any(ptr[k] < len(streams[k]) for k in range(B)):
                    # 1) sequence-initial frames: bs=1, scattered into their slot
                    for k in range(B):
                        if ptr[k] < len(streams[k]) and streams[k][ptr[k]][1]:
                            banks1 = run_first(streams[k][ptr[k]][0])
                            if banks_b is None:
                                banks_b = map_banks(lambda x: torch.cat([x] * B), banks1)
                            else:
                                banks_b = map_banks(
                                    lambda b, x, k=k: torch.cat([b[:k], x, b[k + 1:]]),
                                    banks_b, banks1)
                            ptr[k] += 1
                    # 2) one bs=B forward over the live slots
                    active = [k for k in range(B) if ptr[k] < len(streams[k])]
                    if not active:
                        continue
                    frames = load([streams[k][ptr[k]][0] for k in active], pool)
                    by_slot = dict(zip(active, frames))
                    live = torch.as_tensor(np.isin(np.arange(B), active), device=device)
                    results, banks_b = step([by_slot.get(k, frames[0]) for k in range(B)],
                                            banks_b, live)
                    for k in active:
                        collect(streams[k][ptr[k]][0], by_slot[k], results[k])
                        ptr[k] += 1
    finally:
        if pool:
            pool.shutdown()
        model.train(was_training)
    acc = col.acc
    acc["_eval_det"] = eval_det
    acc["frames"] = frames_done
    acc["load_s"] = load_s
    acc["forward_s"] = forward_s
    return acc


def gather_records(acc: Dict[str, List], rank: int, world: int, gather_dir: Optional[str],
                   gather_timeout: float = 1800.0) -> Optional[Dict[str, List]]:
    """Every rank writes its records to ``gather_dir``; rank 0 waits for
    the others' and merges them in rank order -> the merged records (rank
    0), None (other ranks). ``world == 1`` returns ``acc``."""
    if world <= 1:
        return acc
    if not gather_dir:
        raise ValueError("world > 1 requires gather_dir")
    os.makedirs(gather_dir, exist_ok=True)
    part = os.path.join(gather_dir, f"eval_part_{rank}.pkl")
    tmp = part + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(acc, f)
    os.replace(tmp, part)
    if rank != 0:
        return None
    # rank 0: gather in rank order (`apis/test.py:122-167` semantics)
    deadline = time.time() + gather_timeout
    for r in range(1, world):
        path = os.path.join(gather_dir, f"eval_part_{r}.pkl")
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"eval gather: missing {path}")
            time.sleep(0.2)
        with open(path, "rb") as f:
            acc_r = pickle.load(f)
        for k, v in acc_r.items():
            if isinstance(v, list):
                acc[k].extend(v)
    return acc


def run_openloop_eval(
    model,
    dataset,
    max_frames: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    eval_planning: bool = True,
    eval_det: bool = False,
    eval_map: bool = False,
    eval_motion: bool = False,
    batch_slots: int = 1,
    rank: int = 0,
    world: int = 1,
    gather_dir: Optional[str] = None,
    gather_timeout: float = 1800.0,
    num_workers: int = 0,
) -> Optional[Dict[str, Dict[str, float]]]:
    """Evaluate the val split; returns the metric summary (rank 0) or None
    (other ranks, whose records were written to ``gather_dir``)."""
    acc = collect_records(model, dataset, max_frames, dtype, eval_planning, eval_det,
                          eval_map, eval_motion, batch_slots, rank, world, num_workers)
    acc = gather_records(acc, rank, world, gather_dir, gather_timeout)
    return None if acc is None else summarize(acc)
