"""The numbers that decide ``correct``: the program's outputs against the
plain reference's on the same inputs.

Selections on near ties (the det merge's and the banks' top-k, each
keypoint's two cameras, the motion anchor's class) reorder and exchange
rows between any two precisions, so rows are compared as sets, one to one:
the program's rows and the reference's are paired by the assignment of
least total distance (``scipy.optimize.linear_sum_assignment``), so that no
reference row stands for two program rows and a program whose rows collapse
onto a few, or repeat, reads the distance to the rows it lost. A row's error
is the RMS over its parts (a det row's classification, box, quality, motion
classes and motion) of each part's RMS difference over the reference's RMS
of that part, so that the box's 11 numbers count as much as the motion's
144. A number is a quantile of one part's row errors
(:data:`HEAD_QUANTILES`, :data:`BANK_QUANTILES`): for the det queries and
the det bank the median, since under the benchmark's random weights near
ties exchange up to a tenth of their rows on a sound run; for the map
queries, where no selection exchanges rows, the 99th percentile. The plan
queries are judged by the plan's decision (``plan_gap``): their features
move by up to a tenth under bf16 on some seeds, as much as the control
moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

# the judged quantile of each part's row errors, and the number it makes;
# the other parts are printed only
HEAD_QUANTILES = {"det": ("det_err", 0.5), "map": ("map_err", 0.99)}
BANK_QUANTILES = {"det": ("bank_err", 0.5)}
PRINTED = (0.5, 0.75, 0.9, 0.95, 0.98, 0.99, 1.0)  # the quantiles each part prints


def paired_errors(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]):
    """-> (each program row's error against the reference row it is paired
    with, one to one, by the least total error; each part's error alone, on
    that pairing). ``prog[i]``, ``ref[i]`` are ``[rows, ...]`` parts of one
    row. A part's error is its RMS difference over the reference's RMS of
    that part; a row's, the RMS of its parts' errors, so that every part
    counts the same however wide it is."""
    from scipy.optimize import linear_sum_assignment

    n = prog[0].shape[0]
    p = [t.detach().reshape(n, -1).double().cpu() for t in prog]
    r = [t.detach().reshape(n, -1).double().cpu() for t in ref]
    # each part scaled so that its squared distance is its error squared
    # over the number of parts
    scale = [(b.pow(2).mean().sqrt().clamp_min(1e-12) * (b.shape[1] * len(r)) ** 0.5)
             for b in r]
    ps = torch.cat([a / s for a, s in zip(p, scale)], dim=1)
    rs = torch.cat([b / s for b, s in zip(r, scale)], dim=1)
    rows, cols = linear_sum_assignment(torch.cdist(ps, rs).numpy())
    rows, cols = torch.from_numpy(rows), torch.from_numpy(cols)
    whole = (ps[rows] - rs[cols]).pow(2).sum(dim=1).sqrt()
    parts = [(a[rows] - b[cols]).pow(2).mean(dim=1).sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-12)
             for a, b in zip(p, r)]
    return whole, parts


def quantile(e: torch.Tensor, q: float) -> float:
    return float(torch.quantile(e, q)) if e.numel() > 1 else float(e.max())


def head_parts(outputs: Dict, sample: int = 0) -> Dict[str, List[torch.Tensor]]:
    """The last layer's head outputs of one sample, as rows by task."""
    def last(task, key):
        return outputs[task][key][-1][sample].float()

    det = [last("det", "classification"), last("det", "prediction"), last("det", "quality")]
    if "motion" in outputs:
        det += [last("motion", "classification"), last("motion", "prediction")]
    parts = {"det": det,
             "map": [last("map", "classification"), last("map", "prediction")],
             "plan": [last("plan", "classification")[0], last("plan", "prediction")[0]]}
    return parts


def bank_parts(banks, sample: int = 0) -> Dict[str, List[torch.Tensor]]:
    """The float tensors of one sample's det and plan banks, as rows by
    bank (the plan bank is printed, not judged: see :data:`BANK_QUANTILES`)."""
    d, p = banks.det, banks.plan
    g = p.feature.shape[1] * p.feature.shape[2]
    return {
        "det": [d.feature[sample].float(), d.anchor[sample].float(),
                d.confidence[sample].float()[:, None]],
        "plan": [p.feature[sample].float().reshape(g, -1), p.anchor[sample].float().reshape(g, -1),
                 p.confidence[sample].float().reshape(g, 1)],
    }


def decode_error(prog_dec: Dict, ref_dec: Dict) -> float:
    """The program's decoded outputs against the reference's decode of the
    program's own raw outputs: the largest difference of a float output
    over its largest magnitude (at least 1), and 1 for any integer or flag
    output that differs."""
    err = 0.0
    for k, r in ref_dec.items():
        p = prog_dec[k]
        if r.is_floating_point():
            r, p = r.double(), p.double()
            err = max(err, float((p - r).abs().max()) / max(1.0, float(r.abs().max())))
        elif not torch.equal(p.to(r.dtype), r):
            err = max(err, 1.0)
    return err


def float32(tree):
    """The floating tensors of a nested dict / list as fp32."""
    if isinstance(tree, dict):
        return {k: float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(float32(v) for v in tree)
    return tree.float() if torch.is_tensor(tree) and tree.is_floating_point() else tree


def decoded_parts(dec: Dict, sample: int = 0) -> Dict[str, List[torch.Tensor]]:
    """The decoded detections (with their motion) and map lines of one
    sample, as rows."""
    out = {}
    if "det_boxes_3d" in dec:
        det = [dec["det_boxes_3d"][sample], dec["det_scores_3d"][sample][:, None]]
        if "motion_trajs_3d" in dec:
            det += [dec["motion_trajs_3d"][sample], dec["motion_trajs_score"][sample]]
        out["det"] = [t.float() for t in det]
    if "map_vectors" in dec:
        out["map"] = [dec["map_vectors"][sample].float(), dec["map_scores"][sample][:, None].float()]
    return out


def by_part(prog: Dict[str, List[torch.Tensor]], ref: Dict[str, List[torch.Tensor]],
            judged: Optional[Dict[str, tuple]] = None):
    """-> (the numbers that ``judged`` names, ``{part: (number, quantile)}``;
    each part's row errors at the :data:`PRINTED` quantiles, then the median
    of each of its components alone, for the diagnosis)."""
    numbers, printed = {}, {}
    for k in prog:
        e, comps = paired_errors(prog[k], ref[k])
        if judged and k in judged:
            numbers[judged[k][0]] = quantile(e, judged[k][1])
        printed[k] = [quantile(e, q) for q in PRINTED] + [float(c.median()) for c in comps]
    return numbers, printed


def plan_numbers(cfg, prog_dec: Dict, ref_outputs: Dict, cmd_onehot,
                 sample: int = 0) -> Dict[str, float]:
    """``plan_gap``: how far below the reference's best mode (raw logits of
    the reference group under the command) the program's chosen mode lies.
    ``plan_err``: the largest distance between a program waypoint of a
    temporal or spatial group and the reference's waypoint of the same mode
    and group, over the reference trajectory's largest extent (at least 1
    m). The speed groups' bucket and full stop are decisions of the
    collision rescore, which ``decode_error`` checks on the program's own
    outputs."""
    cls = ref_outputs["plan"]["classification"][-1][sample, 0].double()
    reg = torch.cumsum(ref_outputs["plan"]["prediction"][-1][sample, 0].double(), dim=-2)
    per = cfg.ego_fut_cmd * cfg.ego_fut_mode
    cmd = int(cmd_onehot[sample].argmax()) if cfg.ego_fut_cmd > 1 else 0
    mode = int(prog_dec["plan_mode_idx"][sample])
    types = cfg.plan_anchor_types
    groups = []
    for i in range(len(types)):
        c = cls[per * i:per * (i + 1)].reshape(cfg.ego_fut_cmd, -1)[cmd]
        r = reg[per * i:per * (i + 1)].reshape(cfg.ego_fut_cmd, -1, cfg.ego_fut_ts, 2)[cmd]
        groups.append((c, r))
    refer_cls = groups[types.index(cfg.plan_anchor_refer)][0]
    gap = float(refer_cls.max() - refer_cls[mode])
    err = 0.0
    for kind, unit in [t[:2] for t in types if t[0] in ("temp", "spat")]:
        p = prog_dec[f"plan_{kind}_{unit}"][sample].double()
        r = groups[types.index((kind, unit))][1][mode]
        err = max(err, float((p - r).abs().max()) / max(1.0, float(r.abs().max())))
    return {"plan_gap": gap, "plan_err": err}


@dataclasses.dataclass
class Reading:
    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value == self.value and self.value <= self.limit


def judge(values: Dict[str, float], limits: Dict[str, float]) -> List[Reading]:
    return [Reading(k, float(v), limits.get(k)) for k, v in values.items()]
