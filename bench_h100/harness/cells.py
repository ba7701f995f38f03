"""How a cell drives the program, chosen by its traffic's ``kind``, and
the comparison of what it produced with the reference.

* ``stream_frames``: ``HiPAD.forward`` under bf16 autocast and
  ``postprocess.post_process_arrays``, one recorded frame a unit, its
  inputs uploaded from pinned host memory and its results brought to the
  host as numpy, as the eval runner consumes them; banks carried.

The driver builds the program from the benchmark's weights, warms up, runs
units, keeps what a sample of units (drawn from the seed) produced, frees
the program, and then runs the reference over those units. The reference
follows the program from the program's own input banks (it would drift
from the program's choices on near ties over a long stream); the cold
start, with no banks, is always in the sample.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

import torch

from ..reference import fp8
from ..reference.hipad import postprocess as ref_post
from ..reference.hipad.models import instance_bank as ref_banks
from ..reference.hipad.models.detector import HiPAD as RefHiPAD
from . import check, spec, traffic
from .weights import make_weights

CHECK_STREAM = 0xC4EC


class Reservoir:
    """A uniform sample of ``k`` window units, drawn from the seed whatever
    the window's length (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed * 2 + CHECK_STREAM), 0
        self.items: List = [None] * k

    def slot(self) -> Optional[int]:
        """The slot the next unit takes, or None: it is not kept."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def kept(self) -> List:
        return [x for x in self.items if x is not None]


def reference_banks(b):
    """Any bank states (the program's or the reference's) -> the
    reference's dataclasses, floats in fp32."""
    if b is None:
        return None

    def cv(part, cls):
        return cls(**{f.name: (getattr(part, f.name).float() if
                               getattr(part, f.name).is_floating_point()
                               else getattr(part, f.name))
                      for f in dataclasses.fields(cls)})

    return ref_banks.BankStates(cv(b.det, ref_banks.DetBankState),
                                cv(b.ego, ref_banks.EgoBankState),
                                cv(b.plan, ref_banks.PlanBankState))


class ControlModel(torch.nn.Module):
    """The reference in the program's place, under the program's own
    autocast, with the operands of its GEMMs, convolutions and attention
    products rounded to fp8 (e4m3, one scale a tensor): the control."""

    def __init__(self, ref_model):
        super().__init__()
        self.ref = ref_model

    def forward(self, images, metas, banks=None):
        with fp8.Fp8Mode():
            return self.ref(images, metas, reference_banks(banks))


class StateFault(torch.nn.Module):
    """A planted fault: the step hands back its input banks unchanged."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, metas, banks=None):
        out, new = self.model(images, metas, banks)
        return out, (banks if banks is not None else new)


class RowsFault(torch.nn.Module):
    """A planted fault: a wrong gather index in the det head. In the last
    layer the det queries of each block of four hand on the outputs of the
    block's first (det and motion): the rows collapse onto a quarter of
    themselves, and three quarters of the reference's rows have no
    counterpart."""

    KEYS = {"det": ("classification", "prediction", "quality"),
            "motion": ("classification", "prediction")}

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, images, metas, banks=None):
        out, new = self.model(images, metas, banks)
        out = dict(out)
        for task, keys in self.KEYS.items():
            if task not in out:
                continue
            part = dict(out[task])
            for k in keys:
                layers = part[k]
                last = layers[-1].clone()
                for j in range(1, 4):
                    last[:, j::4] = last[:, 0::4][:, :last[:, j::4].shape[1]]
                part[k] = torch.cat([layers[:-1], last[None]]) if torch.is_tensor(layers) \
                    else list(layers[:-1]) + [last]
            out[task] = part
        return out, new


class CameraFault:
    """A planted fault in the sampler: while installed, the program's two
    sampler entries (``ops.sampling.coarse_sample``, ``patch_sample``) leave
    camera 0 out of every sample (its weights zeroed), so that only the rows
    that camera sees go wrong."""

    def __init__(self):
        from hipad_torch.ops import sampling

        self.sampling = sampling
        self.orig = {n: getattr(sampling, n) for n in ("coarse_sample", "patch_sample")}

    def install(self):
        coarse, patch = self.orig["coarse_sample"], self.orig["patch_sample"]

        def coarse_sample(acc, maps, points_2d, weights, levels):
            weights = weights.clone()
            weights[:, :, 0] = 0  # [bs, M0, cams, L, G]
            return coarse(acc, maps, points_2d, weights, levels)

        def patch_sample(maps, cam, x, y, w, cam_k, lvl=None):
            w = torch.where((cam == 0)[..., None, None], torch.zeros_like(w), w)
            return patch(maps, cam, x, y, w, cam_k, lvl)

        self.sampling.coarse_sample, self.sampling.patch_sample = coarse_sample, patch_sample

    def remove(self):
        for n, fn in self.orig.items():
            setattr(self.sampling, n, fn)


def answer_fault(post_process):
    """A planted fault: every decoded plan waypoint moved by 1 m."""
    def wrapped(*args, **kwargs):
        dec = post_process(*args, **kwargs)
        return {k: (v + 1.0 if k.startswith("plan_") and k != "plan_mode_idx" else v)
                for k, v in dec.items()}
    return wrapped


def mode_fault(post_process):
    """A planted fault: the plan decoded from the reference group's least
    likely mode (its logit raised by 10 in every group)."""
    def wrapped(cfg, outputs, cmd_onehot, *args, **kwargs):
        cls = outputs["plan"]["classification"]
        bs = cls.shape[1]
        g = cls[-1].reshape(bs, len(cfg.plan_anchor_types), cfg.ego_fut_cmd, cfg.ego_fut_mode)
        worst = g[:, cfg.plan_anchor_types.index(cfg.plan_anchor_refer)].argmin(-1)
        bump = torch.nn.functional.one_hot(worst, cfg.ego_fut_mode)
        last = (g + 10.0 * bump[:, None].to(g.dtype)).reshape(cls[-1].shape)
        plan = dict(outputs["plan"], classification=torch.cat([cls[:-1], last[None]]))
        return post_process(cfg, dict(outputs, plan=plan), cmd_onehot, *args, **kwargs)
    return wrapped


POST_FAULTS = {"answer": answer_fault, "mode": mode_fault}
MODEL_FAULTS = {"state": StateFault, "rows": RowsFault}


class Driver:
    """Set-up, units, release and check of one cell."""

    def __init__(self, cell: spec.Cell, seed: int, device, control: Optional[str] = None,
                 fault: Optional[str] = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.params = cell.traffic
        self.control, self.fault = control, fault
        self.cfg = spec.program_config(cell.config)
        self.ref_cfg = spec.reference_config(cell.config)
        self.sample = Reservoir(self.params["check_units"], seed)
        self.cold = None  # the cold start's capture
        self.units = 0
        self.diag: List[Dict] = []  # each checked unit's errors by part (printed, not judged)

    # -- shared pieces -------------------------------------------------------

    def weights(self) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            skeleton = RefHiPAD(self.ref_cfg, device="meta")
        return make_weights(skeleton, self.ref_cfg, self.seed, self.device)

    def reference_model(self):
        model = RefHiPAD(self.ref_cfg, device=self.device)
        model.load_state_dict(self.weights())
        return model.eval()

    def in_place_of_program(self, model):
        """The model the window drives: the program's, or the control, with
        the planted fault if any."""
        if self.control:
            model = ControlModel(self.reference_model())
        if self.fault in MODEL_FAULTS:
            model = MODEL_FAULTS[self.fault](model)
        return model

    def warm_up(self):
        for i in range(self.params["warmup_units"]):
            self.unit(capture=i == 0, cold=i == 0)

    def numbers(self, cap: Dict, ref_out, ref_bank, cmd, with_rescore: bool) -> Dict[str, float]:
        """The numbers of one checked unit: the reference's raw outputs and
        banks against the program's, the program's plan judged by the
        reference's outputs, and the program's decode against the
        reference's decode of the program's own raw outputs."""
        ref_dec = ref_post.post_process_arrays(self.ref_cfg, ref_out, cmd, with_rescore)
        own = ref_post.post_process_arrays(self.ref_cfg, check.float32(cap["outputs"]), cmd,
                                           with_rescore)
        head, head_diag = check.by_part(check.head_parts(cap["outputs"]),
                                        check.head_parts(ref_out), check.HEAD_QUANTILES)
        bank, bank_diag = check.by_part(check.bank_parts(cap["banks_out"]),
                                        check.bank_parts(ref_bank), check.BANK_QUANTILES)
        self.diag.append({
            "head": head_diag, "bank": bank_diag,
            "decoded": check.by_part(check.decoded_parts(cap["decoded"]),
                                     check.decoded_parts(ref_dec))[1]})
        out = {**head, **bank, "decode_err": check.decode_error(cap["decoded"], own)}
        plan = check.plan_numbers(self.ref_cfg, cap["decoded"], ref_out, cmd)
        out["plan_gap"] = plan["plan_gap"]
        self.diag[-1]["plan_err"] = plan["plan_err"]
        return out


def _merge(into: Dict[str, float], new: Dict[str, float]):
    for k, v in new.items():
        into[k] = max(into.get(k, float("-inf")), v)


class StreamFramesDriver(Driver):
    def setup(self):
        from hipad_torch import postprocess
        from hipad_torch.models.common import to_float32
        from hipad_torch.models.detector import HiPAD

        model = HiPAD(self.cfg, device=self.device)
        model.load_state_dict(self.weights())
        self.model = self.in_place_of_program(model.eval())
        self.camera_fault = CameraFault() if self.fault == "camera" else None
        if self.camera_fault:
            self.camera_fault.install()
        post = postprocess.post_process_arrays
        self.post = POST_FAULTS[self.fault](post) if self.fault in POST_FAULTS else post
        self.to_host, self.to_float32 = postprocess.to_result_dicts, to_float32
        self.autocast = self.params["dtype"] == "bf16"
        self.traffic = traffic.StreamFrames(self.params, self.cfg, self.seed, self.device)
        self.banks, self.i = None, 0
        self.warm_up()

    def unit(self, capture: bool = True, cold: bool = False):
        images_host, metas_np = self.traffic.frame(self.i)
        slot = self.sample.slot() if capture and not cold else None
        images = images_host.to(self.device, non_blocking=True)
        metas = {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                 for k, v in metas_np.items()}
        banks_in = self.banks
        with torch.no_grad(), torch.autocast(self.device.type, dtype=torch.bfloat16,
                                             enabled=self.autocast):
            outputs, self.banks = self.model(images, metas, banks_in)
        with torch.no_grad():
            decoded = self.post(self.cfg, self.to_float32(outputs), metas["gt_ego_fut_cmd"])
        self.to_host(decoded)  # waits for the frame
        if slot is not None or cold:
            cap = dict(i=self.i, banks_in=banks_in, outputs=outputs, banks_out=self.banks,
                       decoded=decoded)
            if cold:
                self.cold = cap
            else:
                self.sample.items[slot] = cap
        self.i += 1
        self.units += 1

    def release(self):
        if self.camera_fault:
            self.camera_fault.remove()
        del self.model
        self.banks = None

    def check(self) -> Dict[str, float]:
        ref = self.reference_model()
        values: Dict[str, float] = {}
        for cap in [self.cold] + self.sample.kept():
            images_host, metas_np = self.traffic.frame(cap["i"])
            images = images_host.to(self.device)
            metas = {k: torch.from_numpy(v).to(self.device) for k, v in metas_np.items()}
            with torch.no_grad():
                out, bank = ref(images, metas, reference_banks(cap["banks_in"]))
                got = self.numbers(cap, out, bank, metas["gt_ego_fut_cmd"], True)
            _merge(values, got)
        return values


DRIVERS = {"stream_frames": StreamFramesDriver}


def driver(cell: spec.Cell, seed: int, device, **kw) -> Driver:
    return DRIVERS[cell.traffic["kind"]](cell, seed, device, **kw)
