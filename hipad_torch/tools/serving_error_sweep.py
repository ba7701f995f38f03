"""End-to-end accuracy cost of the serving approximations on the port
(counterpart of ``tools/serving_error_sweep.py``).

Runs the decoder with shared weights on shared inputs, once with exact
sampling (``sampler_cam_k=6``, ``sampler_point_frac=1.0``: every camera and
keypoint sampled, as the reference's ``deformable_aggregation_cuda.cu``
does) and once per row of serving knobs, over a two-frame episode (the
second frame on the first frame's banks), and reports per-task deltas of
the outputs that matter downstream:

  * det: decoded-box centre L2 and max-class-score delta over the exact
    run's top-100 scoring anchors;
  * map: polyline point L2 over the exact run's top-20 lines;
  * plan: L2 of the decoded closed-loop trajectory (``post_process_arrays``'
    ``plan_speed_5hz``, what the PID consumes) and how many anchor groups'
    argmax mode flipped.

Rows: ``cam_k=3``; ``cam_k=2`` with renorm at point fractions 1.0 to 0.2;
``sampler_level_k=1`` alone and with frac 0.25; plan-mode pruning
(``topk_mode`` 12 from layer 3); det-query pruning (``topk_det`` 450 from
layer 3); both prunings (``stage2_serving_prune``).

By default the decoder alone runs, with seeded random weights
(``weights.init_random``) on seeded random feature maps. ``--load-from`` a
work dir of the port's checkpoints runs the whole ``HiPAD`` in fp32 on
synthetic camera frames. ``--mode-correlation`` prints, from the exact run,
how much of the final ranking each layer's pruning cut would keep.
The model runs on the card unless ``--device cpu``. Prints a markdown table
and one JSON line per row; writes no file.

    python -m hipad_torch.tools.serving_error_sweep [--half-res] [--only level_k]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_DET = dict(with_topk_det=True, topk_det_list=(900, 900, 450, 450, 450, 450))
_RENORM = dict(sampler_cam_k=2, sampler_cam_renorm=True)
ROWS: List[Tuple[str, Dict]] = (
    [("cam_k=3 (exact-rig)", dict(sampler_cam_k=3, sampler_cam_renorm=False,
                                  sampler_point_frac=1.0))]
    + [(f"cam_k=2+renorm, frac={frac}", dict(_RENORM, sampler_point_frac=frac))
       for frac in (1.0, 0.5, 0.34, 0.25, 0.2)]
    + [("cam_k=2+renorm, level_k=1", dict(_RENORM, sampler_point_frac=1.0, sampler_level_k=1)),
       ("cam_k=2+renorm, frac=0.25, level_k=1",
        dict(_RENORM, sampler_point_frac=0.25, sampler_level_k=1)),
       # plan-mode pruning reorders the modes by score: the positional
       # mode_flips column does not apply to this row, the trajectory L2 does
       ("cam_k=2+renorm, frac=0.25, topk_mode 12@L3+",
        dict(_RENORM, sampler_point_frac=0.25, with_topk_mode=True,
             topk_mode_list=(48, 48, 12, 12, 12, 12), num_temp_plan_mode=12)),
       # the det pruning's cold-start sort permutes frame 1's det slots: its
       # f1 det columns compare different instances; f2's are slot-aligned
       ("cam_k=2+renorm, frac=0.25, topk_det 450@L3+",
        dict(_RENORM, sampler_point_frac=0.25, **_DET)),
       ("serving_prune (topk_mode 12 + topk_det 450)",
        dict(_RENORM, sampler_point_frac=0.25, with_topk_mode=True,
             topk_mode_list=(48, 48, 12, 12, 12, 12), num_temp_plan_mode=12, **_DET))])
TABLE_COLS = ["f2_det_center_l2", "f2_det_score_d", "f2_map_pt_l2", "f2_plan_l2",
              "f2_mode_flips"]


def sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def deltas(approx, exact, exact_cfg):
    """The per-task deltas of an approximate two-frame run against the
    exact one (each a list of two dicts of numpy arrays)."""
    out = {}
    for fi, (e, a) in enumerate(zip(exact, approx), start=1):
        ecls = e["det_cls"].reshape(-1, e["det_cls"].shape[-1])
        acls = a["det_cls"].reshape(ecls.shape)
        score = sig(ecls).max(-1)
        top = np.argsort(-score)[:100]
        ebox = e["det_box"].reshape(ecls.shape[0], -1)
        abox = a["det_box"].reshape(ebox.shape)
        out[f"f{fi}_det_center_l2"] = float(np.mean(np.linalg.norm(
            ebox[top, :3] - abox[top, :3], axis=-1)))
        out[f"f{fi}_det_score_d"] = float(np.mean(np.abs(
            sig(ecls[top]).max(-1) - sig(acls[top]).max(-1))))

        emc = e["map_cls"].reshape(-1, e["map_cls"].shape[-1])
        mtop = np.argsort(-sig(emc).max(-1))[:20]
        empts = e["map_pts"].reshape(emc.shape[0], -1, 2)
        ampts = a["map_pts"].reshape(empts.shape)
        out[f"f{fi}_map_pt_l2"] = float(np.mean(np.linalg.norm(
            empts[mtop] - ampts[mtop], axis=-1)))

        etraj = e["traj"].reshape(-1, 2)
        atraj = a["traj"].reshape(etraj.shape)
        out[f"f{fi}_plan_l2"] = float(np.mean(np.linalg.norm(
            etraj - atraj, axis=-1)))
        epc = e["plan_cls"].reshape(
            exact_cfg.plan_anchor_group, -1)  # [group, cmd*mode]
        apc = a["plan_cls"].reshape(epc.shape)
        out[f"f{fi}_mode_flips"] = int(
            (epc.argmax(-1) != apc.argmax(-1)).sum())
    return out


def _print_retention(cfg, frames):
    """Per-layer ranking retention from an exact run (no pruning active).

    plan: for each refine layer L and anchor group g, is the FINAL layer's
    argmax mode inside layer L's top-k (k=12, the shipped schedule)?
    `with_topk_mode` prunes by the current layer's score, so this is exactly
    its risk of discarding the eventual winner.

    det: the final top-300 instances (by score) vs the positional
    confidence-segment prefix that ``topk_det_list`` 450@L3+ keeps
    (slots [0:300] of the temporal 600 + [600:750] of the fresh 300), and,
    for comparison, a dynamic per-layer top-450 by layer score.
    """
    import json

    import numpy as np

    def sig(x):
        return 1.0 / (1.0 + np.exp(-x))

    out = {}
    for fi, fr in enumerate(frames, start=1):
        ng = cfg.plan_anchor_group
        pstack = fr["plan_cls_stack"]  # [L, bs, 1, n_plan]
        L = pstack.shape[0]
        p = pstack.reshape(L, ng, -1)  # [L, group, cmd*mode]
        winner = p[-1].argmax(-1)  # [group]
        for k in (12, 6):
            keep = np.argsort(-p, axis=-1)[..., :k]  # [L, group, k]
            ret = [(keep[l] == winner[:, None]).any(-1).mean()
                   for l in range(L)]
            out[f"f{fi}_plan_top{k}_retention_by_layer"] = [
                round(float(r), 3) for r in ret]

        dstack = fr["det_cls_stack"]  # [L, bs, n_det, n_cls]
        ds = sig(dstack[..., 0, :, :].max(-1))  # [L, n_det]
        final_top = set(np.argsort(-ds[-1])[:300].tolist())
        nt = cfg.num_temp_det_anchor
        tk, nk = 300, 150  # the shipped 450@L3+ proportional split
        static_keep = set(range(tk)) | set(range(nt, nt + nk))
        out[f"f{fi}_det_static450_retention_of_final_top300"] = round(
            len(final_top & static_keep) / 300.0, 3)
        dyn = [round(len(final_top
                         & set(np.argsort(-ds[l])[:450].tolist())) / 300.0, 3)
               for l in range(ds.shape[0])]
        out[f"f{fi}_det_dyn450_retention_by_layer"] = dyn
        # score mass: how much of the final total sigmoid mass the static
        # keep covers (misranked low-score instances matter little)
        out[f"f{fi}_det_static450_score_mass"] = round(float(
            ds[-1][sorted(static_keep)].sum() / ds[-1].sum()), 3)
    print(json.dumps(out, indent=1))


def exact_knobs(cfg) -> Dict:
    """The exact sampler: every camera, every keypoint."""
    return dict(sampler_cam_k=cfg.num_cams, sampler_cam_renorm=False, sampler_point_frac=1.0)


def episode_inputs(cfg, seed_f1: int, seed_f2: int, use_full: bool):
    """Two frames' inputs as numpy arrays: seeded random feature maps
    ``[1, cams, H/s, W/s, C]`` for the decoder alone, or synthetic camera
    frames for the whole model, and their metas (0.5 s and 0.5 m apart)."""
    from ..data import synthetic

    h, w = cfg.input_size

    def fmaps(seed):
        r = np.random.RandomState(seed)
        return [(r.randn(1, cfg.num_cams, h // s, w // s, cfg.embed_dims)
                 .astype(np.float32) * 0.5) for s in cfg.strides[:cfg.num_levels]]

    def metas(t):
        m = synthetic.make_metas(cfg, 1, seed=7, timestamp=t, ego_xy=(0.5 * t, 0.1 * t))
        return {k: v for k, v in m.items() if k != "focal"}

    if use_full:
        frames = [synthetic.make_images(cfg, 1, seed=s) for s in (seed_f1, seed_f2)]
    else:
        frames = [fmaps(s) for s in (seed_f1, seed_f2)]
    return frames, [metas(0.0), metas(0.5)]


def make_runner(state_dict, frames, metas, use_full: bool, device) -> Callable:
    """-> ``run(cfg, keep_stacks=False)``: the two-frame episode of ``cfg``'s
    model with ``state_dict``, fp32, eval mode -> two dicts of numpy arrays
    (the last layer's det, map and plan heads and the decoded trajectory;
    with ``keep_stacks`` every layer's det and plan scores), and the
    episode's kernel launches."""
    import torch

    from .. import postprocess
    from ..models.decoder import SparseOneDecoder
    from ..models.detector import HiPAD
    from ..ops import kernels

    dev = torch.device(device)

    def to_dev(x):
        if isinstance(x, list):
            return [torch.as_tensor(a, device=dev) for a in x]
        return torch.as_tensor(x, device=dev)

    inputs = [(to_dev(f), {k: to_dev(v) for k, v in m.items()}) for f, m in zip(frames, metas)]

    def run(cfg, keep_stacks=False):
        model = HiPAD(cfg, device=dev) if use_full else SparseOneDecoder(cfg).to(dev)
        model.load_state_dict(state_dict)
        model.eval()
        before = {k.name: k.launches for k in kernels.KERNELS}
        outs, banks = [], None
        with torch.no_grad():
            for f, m in inputs:
                out, banks = model(f, m, banks)
                dec = postprocess.post_process_arrays(cfg, out, m["gt_ego_fut_cmd"],
                                                      with_rescore=False)
                keep = {"det_cls": out["det"]["classification"][-1],
                        "det_box": out["det"]["prediction"][-1],
                        "map_cls": out["map"]["classification"][-1],
                        "map_pts": out["map"]["prediction"][-1],
                        "plan_cls": out["plan"]["classification"][-1],
                        "traj": dec["plan_speed_5hz"]}
                if keep_stacks:
                    keep["det_cls_stack"] = out["det"]["classification"]
                    keep["plan_cls_stack"] = out["plan"]["classification"]
                outs.append({k: v.float().cpu().numpy() for k, v in keep.items()})
        launches = {k.name: k.launches - before[k.name] for k in kernels.KERNELS
                    if k.launches > before[k.name]}
        return outs, launches

    return run


def sweep(run: Callable, make_cfg: Callable, rows: Sequence[Tuple[str, Dict]],
          exact_cfg) -> List[Dict]:
    """Each row's deltas against the exact run, its config name in
    ``config`` and its kernel launches in ``launches``; prints a JSON line
    per row."""
    exact, _ = run(exact_cfg)
    out = []
    for name, knobs in rows:
        approx, launches = run(make_cfg(**knobs))
        d = deltas(approx, exact, exact_cfg)
        d["config"] = name
        d["launches"] = launches
        out.append(d)
        print(json.dumps(d), flush=True)
    return out


def print_table(rows: Sequence[Dict]):
    print("\n| config | det center L2 (m) | det score Δ | map pt L2 (m) "
          "| plan traj L2 (m) | mode flips |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print("| " + r["config"] + " | " + " | ".join(f"{r[c]:.4g}" for c in TABLE_COLS) + " |")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card)")
    ap.add_argument("--half-res", action="store_true",
                    help="176x320 feature pyramid (faster; frac/cam errors "
                         "are resolution-insensitive)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="run only sweep rows whose name contains any of "
                         "these comma-separated substrings (the exact "
                         "run always runs)")
    ap.add_argument("--load-from", default=None,
                    help="a work dir of the port's checkpoints: sweep the whole "
                         "model (backbone and decoder) on synthetic frames")
    ap.add_argument("--ckpt-step", type=int, default=None)
    ap.add_argument("--mode-correlation", action="store_true",
                    help="print per-layer ranking-retention stats from the "
                         "exact run (see the module docstring) and exit")
    args = ap.parse_args(argv)

    import torch

    from ..configs.model import stage2
    from ..models.decoder import SparseOneDecoder
    from ..train import checkpoint
    from ..weights import init_random

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serving_error_sweep: no CUDA device (pass --device cpu to run on "
                         "the CPU)")
    base = dict(input_size=(176, 320) if args.half_res else (352, 640), decoder_remat=False)

    def make_cfg(**knobs):
        return stage2(**base, **knobs)

    exact_cfg = make_cfg(**exact_knobs(stage2()))
    use_full = args.load_from is not None
    frames, metas = episode_inputs(exact_cfg, 11, 23, use_full)
    if use_full:
        state_dict = checkpoint.load_variables(args.load_from, step=args.ckpt_step)
    else:
        state_dict = init_random(SparseOneDecoder(exact_cfg).to(args.device),
                                 args.seed).state_dict()
    run = make_runner(state_dict, frames, metas, use_full, args.device)
    if args.mode_correlation:
        _print_retention(exact_cfg, run(exact_cfg, keep_stacks=True)[0])
        return None
    rows = ROWS
    if args.only is not None:
        subs = [s.strip() for s in args.only.split(",")]
        rows = [r for r in rows if any(sub in r[0] for sub in subs)]
    out = sweep(run, make_cfg, rows, exact_cfg)
    print_table(out)
    return out


if __name__ == "__main__":
    main()
