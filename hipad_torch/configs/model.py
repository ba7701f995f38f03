"""Model configuration: the port's own copy of ``hipad_tpu/configs/model.py``.

The port imports nothing of the JAX package, so it keeps this copy;
``tests/test_torch_port_copies.py`` holds every field of ``tiny()`` and
``stage2()``, anchors included, to the original bit for bit. Left out:
``assert_supported_batch``, a guard against a fault of the TPU runtime.

The original's notes follow.

Model configuration (plain dataclasses — no registry system).

The reference wires every component through mmcv's string registry and two
~650-line python config files (`projects/configs/hipad_b2d_stage{1,2}.py`).
Here the load-bearing ideas are kept — the *operation-order-as-data* decoder
program, the two-stage task split, the per-task anchor/keypoint settings —
as one typed dataclass tree.

K-means anchors are data (the reference ships them as .npy). ``load_anchors``
reads them from disk when available and synthesises plausible stand-ins
otherwise (tests / fresh setups); `tools/kmeans.py` can regenerate real ones
from a dataset.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..data import pipelines as pp

# A plan anchor type is ("temp"|"spat"|"speed", unit, [speed_range]).
PlanAnchorType = Tuple

SINGLE_FRAME_LAYER = (
    "concat", "gnn", "inter_gnn", "norm", "split",
    "deformable", "concat", "ffn", "norm", "split", "refine",
)
TEMPORAL_FRAME_LAYER = (
    "concat", "temp_gnn", "gnn", "inter_gnn", "norm", "split",
    "deformable", "concat", "ffn", "norm", "split", "refine",
)

DET_CLASS_NAMES = (
    "car", "van", "truck", "bicycle", "traffic_sign", "traffic_cone",
    "traffic_light", "pedestrian", "others",
)
MAP_CLASS_NAMES = ("Broken", "Solid", "SolidSolid", "Center")

# K-means anchor data assets (shipped with the repo; regenerate with
# tools/kmeans.py from a dataset).
REFERENCE_KMEANS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "kmeans",
)


@dataclasses.dataclass(frozen=True)
class KeypointSpec:
    """Box keypoints: fixed box-frame scales + learnable offsets."""

    fix_scale: Tuple[Tuple[float, float, float], ...]
    num_learnable: int


@dataclasses.dataclass(frozen=True)
class PointKeypointSpec:
    """Polyline keypoints: per-sample learnable 2D offsets x fixed heights."""

    num_sample: int
    num_learnable: int
    fix_height: Tuple[float, ...]
    ground_height: float


DET_KPS = KeypointSpec(
    fix_scale=(
        (0.0, 0.0, 0.0),
        (0.45, 0.0, 0.0),
        (-0.45, 0.0, 0.0),
        (0.0, 0.45, 0.0),
        (0.0, -0.45, 0.0),
        (0.0, 0.0, 0.45),
        (0.0, 0.0, -0.45),
    ),
    num_learnable=6,
)
EGO_KPS = KeypointSpec(fix_scale=((0.45, 0.0, 0.0),), num_learnable=12)

GROUND_HEIGHT = -1.84023  # lidar-frame ground height (stage2 config:345)


@dataclasses.dataclass(frozen=True, eq=False)
class HiPADConfig:
    # --- tasks / query layout -------------------------------------------------
    task_select: Tuple[str, ...] = ("det", "map", "plan", "ego", "motion")
    query_select: Tuple[str, ...] = ("det", "map", "plan", "ego")
    operation_order: Tuple[str, ...] = SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 5
    num_single_frame_decoder: int = 1

    # --- widths ---------------------------------------------------------------
    embed_dims: int = 256
    num_groups: int = 8  # attention heads == sampling groups
    drop_out: float = 0.1
    decouple_attn: bool = True

    # --- image / camera -------------------------------------------------------
    num_cams: int = 6
    input_size: Tuple[int, int] = (352, 640)  # (H, W)
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    num_depth_layers: int = 3

    # --- backbone ---------------------------------------------------------
    backbone_stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    backbone_base_planes: int = 64
    backbone_remat: bool = True
    # Stages whose blocks are rematerialized when backbone_remat is on.
    # Activation memory lives in the early (large-H*W) stages while replay
    # FLOPs are ~uniform per stage, so dropping the late stages from the
    # remat set trades a little memory for less recompute
    # (A/B via tools/bench_train.py --set backbone_remat_stages=...).
    backbone_remat_stages: Tuple[int, ...] = (0, 1, 2, 3)
    use_grid_mask: bool = True

    # --- det --------------------------------------------------------------
    num_det_anchor: int = 900
    num_temp_det_anchor: int = 600
    num_det_classes: int = len(DET_CLASS_NAMES)
    det_kps: KeypointSpec = DET_KPS
    zero_velocity_class_ids: Tuple[int, ...] = (4, 5, 6)  # sign, cone, light
    det_score_threshold: float = 0.05
    det_num_output: int = 300

    # --- map --------------------------------------------------------------
    num_map_anchor: int = 100
    num_map_classes: int = len(MAP_CLASS_NAMES)
    map_num_pts: int = 20
    map_kps: PointKeypointSpec = PointKeypointSpec(
        num_sample=20, num_learnable=3,
        fix_height=(0.0, 0.5, -0.5, 1.0, -1.0), ground_height=GROUND_HEIGHT,
    )
    map_roi_size: Tuple[float, float] = (30.0, 60.0)

    # --- ego ----------------------------------------------------------------
    ego_kps: KeypointSpec = EGO_KPS
    ego_status_dims: int = 6

    # --- plan -------------------------------------------------------------
    ego_fut_ts: int = 6
    ego_fut_cmd: int = 1
    ego_fut_mode: int = 48
    num_temp_plan_mode: int = 48
    plan_anchor_types: Tuple[PlanAnchorType, ...] = (
        ("temp", "5hz"), ("spat", "2m"), ("temp", "2hz"), ("spat", "5m"),
        ("speed", "5hz", (0.0, 0.4)), ("speed", "5hz", (0.4, 3.0)), ("speed", "5hz", (3.0, 999.0)),
        ("speed", "2hz", (0.0, 0.4)), ("speed", "2hz", (0.4, 3.0)), ("speed", "2hz", (3.0, 999.0)),
    )
    plan_anchor_refer: PlanAnchorType = ("spat", "2m")
    plan_speed_refer: PlanAnchorType = ("temp", "5hz")
    plan_kps: PointKeypointSpec = PointKeypointSpec(
        num_sample=6, num_learnable=3,
        fix_height=(0.0, 0.5, -0.5, 1.0, -1.0), ground_height=GROUND_HEIGHT,
    )
    num_command: int = 6
    with_command_embed: bool = True
    with_target_point_embed: bool = True
    with_supervise_ego_status: bool = True
    with_ego_instance_feature: bool = True

    # --- motion -------------------------------------------------------------
    fut_ts: int = 6
    fut_mode: int = 6
    num_motion_classes: int = 9

    # --- temporal banks -----------------------------------------------------
    default_time_interval: float = 0.5
    max_time_interval: float = 2.0
    confidence_decay: float = 0.6
    det_feat_grad: bool = False

    # --- optional interactive-attention biases (OFF in shipped configs,
    # `sparse_onedecoder.py:581-610`; see models/attn_masks.py) -------------
    with_distance_attn_mask: bool = False
    with_velocity_attn_mask: bool = False

    # --- optional point-expanded map/plan queries (OFF in shipped configs,
    # `sparse_onedecoder.py:145-148,676-724`): in concat/gnn/split ops each
    # map anchor becomes 20 per-point queries (plan: ego_fut_ts) sharing the
    # instance feature, with per-point positional embeds; split squeezes
    # back through an MLP. with_deform_*_points feeds the per-point embeds
    # to the deformable weights head (`blocks.py:178-189`). ------------------
    with_concat_map_points: bool = False
    with_concat_plan_points: bool = False
    with_deform_map_points: bool = False
    with_deform_plan_points: bool = False

    # --- optional per-layer plan-mode pruning (OFF in shipped configs,
    # `sparse_onedecoder.py:150-152,982-1007`): after refine layer i keep the
    # top ``topk_mode_list[i]`` modes per anchor-type group. Live queries are
    # really pruned (static per-layer shapes); only the per-layer OUTPUT
    # stacks are padded back to the full count, with cls=-1e9 / reg=+1e6 so
    # no downstream argmin/topk/loss target ever selects a padded slot. ----
    with_topk_mode: bool = False
    topk_mode_list: Optional[Tuple[int, ...]] = None
    keep_topk_relative_pos: bool = False

    # --- optional det-query pruning (serving knob, no reference counterpart
    # as a decoder feature — but it reuses the reference's own confidence
    # ranking: the temporal segment is cached top-K sorted by decayed
    # confidence (`instance_bank.py:164-196`) and the fresh segment is the
    # merge's top-(N-K) sorted by single-frame confidence
    # (`instance_bank.py:125-162`). ``topk_det_list[i]`` = det queries kept
    # AFTER refine layer i; layers i+1.. then attend/sample/refine only the
    # kept queries. TPU-first design: because both segments arrive
    # confidence-SORTED, pruning is a static prefix slice per segment (split
    # proportionally, temp:fresh = num_temp:num_fresh) — zero gathers, no
    # permutation, every bank slot-alignment invariant preserved. Dropped
    # queries freeze at their drop-layer state: per-layer output stacks and
    # the end-of-frame bank/instance-id interfaces are re-spliced from saved
    # tails (real values, not sentinels), so the temporal bank continues to
    # decay/rank/track them exactly as if they had stopped improving. On
    # cold-start samples (no valid temporal gap / no bank) the fresh set is
    # confidence-sorted and Bresenham-interleaved into the segment geometry
    # (instance_bank.det_cold_layout) so the prefix keeps exactly the
    # top-k single-frame detections. See models/decoder.py.
    with_topk_det: bool = False
    topk_det_list: Optional[Tuple[int, ...]] = None

    # --- deformable sampler backend (see ops/sampling.py) -------------------
    # "reference": row gathers (parity oracle) | "topk": camera-compacted
    # patch gathers + Pallas MXU sampling on coarse levels (production TPU
    # path) | "zero": full prepare but no sampling (perf-ablation only).
    sampler: str = "topk"
    # cam_k=3 is exact for the Bench2Drive rig including near-field corner
    # cases: the five 70-deg FOVs at 55-deg yaw spacing and the 110-deg
    # rear camera admit no azimuthal triple overlap beyond ~3 m, and the
    # <=1 m camera-origin parallax can add at most one extra in-bounds
    # camera closer in — the reference multiplies the remaining cameras'
    # samples by zero anyway (`blocks.py:178-214` softmax over all 6).
    # k=2 alone would drop the third camera's softmax share for near-field
    # (<~3 m) triple-overlap points; with sampler_cam_renorm=True the kept
    # cameras' (level, group) weight sums are renormalised to the full
    # in-bounds mass — an exact no-op wherever <= k cameras see the point
    # (everywhere but near-field), and an unbiased multi-view average for
    # the triple-overlap residue (error bounds measured in
    # tests/test_sampling.py::test_cam_k_triple_overlap_bound and
    # ::test_cam_renorm_exact_when_k_covers). cam_k=3 restores the exact
    # reference semantics at ~1.5x the gather cost.
    sampler_cam_k: int = 2
    sampler_cam_renorm: bool = True
    # Keypoint top-k by softmax weight mass (serving knob; 1.0 = exact).
    # Each query keeps ceil(frac * num_pts) of its keypoints per layer,
    # with the truncated per-group mass renormalised onto the kept points
    # (ops/sampling.py:deformable_aggregation_topk point_k).
    sampler_point_frac: float = 1.0
    sampler_matmul_levels: Tuple[int, ...] = (2, 3)
    # Per-sample GATHER-level top-k by softmax weight mass (serving knob;
    # None = exact). Each compacted (point, camera) sample keeps only its
    # `level_k` highest-mass fine levels (the levels not in
    # sampler_matmul_levels), sampled from a combined zero-padded fine
    # pyramid with ONE patch gather per kept level — gather rows drop by
    # n_fine/level_k. With sampler_level_renorm=True the kept levels'
    # per-group mass is renormalised to the full fine mass (exact no-op
    # whenever the dropped levels carry zero weight; error bounds in
    # tests/test_sampling.py::test_level_topk_*).
    sampler_level_k: Optional[int] = None
    sampler_level_renorm: bool = True
    # Gather each sample's whole (2,2,C) bilinear patch as ONE pre-packed
    # 4C row (ops/sampling.py:build_packed_level) instead of a (2,2,C)
    # slice gather — XLA:TPU gathers are per-row latency-bound.
    sampler_row_packed: bool = False
    # Fuse all tasks' sampling into one call per layer. Measured slightly
    # slower than per-task calls (concat copies outweigh the amortized
    # dispatch overhead) — kept as an option.
    fused_deformable: bool = False
    # Rematerialize the deformable ops in the backward pass: their sampling
    # intermediates (patch gathers + interpolation operands) dominate autodiff
    # residual memory at train time (counterpart of the reference's fp16 +
    # backbone-only with_cp fitting a 24 GB GPU; v5e has 16 GB HBM).
    decoder_remat: bool = True

    # --- misc --------------------------------------------------------------
    cls_threshold_to_reg: float = 0.05
    # MFU-attribution ablation (tools/mfu_accounting.py): stop the gradient
    # at the backbone->decoder boundary, killing conv dgrad/wgrad, the remat
    # replay AND the sampler's dense feature-map adjoints in one cut so the
    # end-to-end step-time delta attributes that whole family. Never enable
    # for real training.
    stop_fmap_gradient: bool = False

    # --- anchor data (numpy; excluded from equality/hash) --------------------
    det_anchor: np.ndarray = None
    map_anchor: np.ndarray = None
    motion_anchor: np.ndarray = None
    plan_anchor: np.ndarray = None  # [group * cmd * mode, ego_fut_ts*2]

    def __post_init__(self):
        # cross-field invariants that are easy to violate in overrides
        if self.plan_kps.num_sample != self.ego_fut_ts:
            raise ValueError(
                f"plan_kps.num_sample ({self.plan_kps.num_sample}) must equal "
                f"ego_fut_ts ({self.ego_fut_ts}) — plan keypoints ride the "
                "anchor trajectory's waypoints"
            )
        if self.map_kps.num_sample != self.map_num_pts:
            raise ValueError(
                f"map_kps.num_sample ({self.map_kps.num_sample}) must equal "
                f"map_num_pts ({self.map_num_pts})"
            )
        if self.embed_dims % self.num_groups != 0:
            raise ValueError("embed_dims must divide into num_groups")
        if self.with_topk_mode:
            n_refine = self.operation_order.count("refine")
            if self.topk_mode_list is None or len(self.topk_mode_list) < n_refine:
                raise ValueError(
                    "with_topk_mode needs topk_mode_list with one entry per "
                    f"refine layer ({n_refine}); got {self.topk_mode_list!r}"
                )
            if any(k < 1 for k in self.topk_mode_list):
                raise ValueError("topk_mode_list entries must be >= 1")
            # The decoder pools modes per anchor-type GROUP (cmd folded into
            # the pooled axis) and pads the pruned tail, while
            # plan_bank_cache top-ks per (group x cmd) sub-block of
            # ego_fut_mode slots — so the LAST cmd sub-block only sees
            # k_last - (cmd-1)*ego_fut_mode live entries and must still
            # cover num_temp_plan_mode of them.
            k_last = self.topk_mode_list[n_refine - 1]
            need = ((self.ego_fut_cmd - 1) * self.ego_fut_mode
                    + self.num_temp_plan_mode)
            if k_last < need:
                raise ValueError(
                    "with_topk_mode: the last layer keeps "
                    f"{k_last} modes/group but the plan bank caches "
                    f"num_temp_plan_mode={self.num_temp_plan_mode} per "
                    f"(group x cmd) sub-block (needs k_last >= {need} for "
                    f"ego_fut_cmd={self.ego_fut_cmd}) — padded "
                    "zero-confidence slots would become temporal instances"
                )
        if self.with_topk_det:
            n_refine = self.operation_order.count("refine")
            if self.topk_det_list is None or len(self.topk_det_list) < n_refine:
                raise ValueError(
                    "with_topk_det needs topk_det_list with one entry per "
                    f"refine layer ({n_refine}); got {self.topk_det_list!r}"
                )
            lst = self.topk_det_list[:n_refine]
            if any(k < 2 or k > self.num_det_anchor for k in lst):
                raise ValueError(
                    "topk_det_list entries must be in [2, num_det_anchor]")
            if any(a < b for a, b in zip(lst, lst[1:])):
                raise ValueError(
                    "topk_det_list must be non-increasing (pruned queries "
                    "cannot come back — their features stop being refined)")
            # pruning can only start once the temporal merge has produced the
            # confidence-sorted [temporal | fresh] segment layout
            if any(k < self.num_det_anchor
                   for k in lst[: self.num_single_frame_decoder - 1]):
                raise ValueError(
                    "topk_det_list may prune only from refine layer "
                    f"{self.num_single_frame_decoder - 1} on (the temporal "
                    "merge that sorts the segments happens there)")
            n_temp = self.num_temp_det_anchor
            for k in lst:
                t = k * n_temp // self.num_det_anchor
                if k < self.num_det_anchor and (t < 1 or k - t < 1):
                    raise ValueError(
                        f"topk_det_list entry {k} leaves an empty segment "
                        f"(proportional split {t}/{k - t})")
        if (self.with_concat_map_points or self.with_concat_plan_points) and (
                self.with_distance_attn_mask or self.with_velocity_attn_mask):
            raise ValueError(
                "point-expanded concat (with_concat_{map,plan}_points) is "
                "incompatible with distance/velocity attention masks: the "
                "bias matrices are sized from anchor counts while inter_gnn "
                "sections are point-expanded, mismatching the logits at "
                "trace time"
            )

    # ---- derived -------------------------------------------------------------
    @property
    def plan_anchor_group(self) -> int:
        return len(self.plan_anchor_types)

    @property
    def num_plan_anchor(self) -> int:
        return self.plan_anchor_group * self.ego_fut_cmd * self.ego_fut_mode

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def query_counts(self) -> Dict[str, int]:
        return {
            "det": self.num_det_anchor,
            "map": self.num_map_anchor,
            "plan": self.num_plan_anchor,
            "ego": 1,
        }

    @property
    def temp_query_counts(self) -> Dict[str, int]:
        return {
            "det": self.num_temp_det_anchor,
            "map": 0,
            "plan": self.plan_anchor_group * self.ego_fut_cmd * self.num_temp_plan_mode,
            "ego": 1,
        }

    def sections(self, counts: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
        out, start = {}, 0
        for q in self.query_select:
            out[q] = (start, start + counts[q])
            start += counts[q]
        return out

    @property
    def speed_areas(self) -> Tuple[Tuple[float, float], ...]:
        areas = []
        for t in self.plan_anchor_types:
            if t[0] == "speed" and t[2] not in areas:
                areas.append(t[2])
        return tuple(areas)

    @property
    def ego_anchor_init(self) -> np.ndarray:
        """Fixed b2d ego vehicle box (`models/ego/instance_bank.py:52-58`)."""
        return np.array(
            [[0.0, 0.5, -1.84 + 1.49 / 2, np.log(4.89), np.log(1.84), np.log(1.49),
              1.0, 0.0, 0.0, 0.0, 0.0]],
            dtype=np.float32,
        )


def _synthetic_anchors(cfg_kwargs: dict, rng: np.random.RandomState):
    """Plausible stand-in anchors when the kmeans .npy files are absent."""
    nd = cfg_kwargs.get("num_det_anchor", 900)
    nm = cfg_kwargs.get("num_map_anchor", 100)
    npts = cfg_kwargs.get("map_num_pts", 20)
    n_cls = cfg_kwargs.get("num_motion_classes", 9)
    fut_mode = cfg_kwargs.get("fut_mode", 6)
    fut_ts = cfg_kwargs.get("fut_ts", 6)
    ego_ts = cfg_kwargs.get("ego_fut_ts", 6)
    ego_mode = cfg_kwargs.get("ego_fut_mode", 48)
    n_types = len(cfg_kwargs.get("plan_anchor_types", HiPADConfig.plan_anchor_types))
    cmd = cfg_kwargs.get("ego_fut_cmd", 1)

    det = np.zeros((nd, 11), np.float32)
    det[:, 0] = rng.uniform(-15, 15, nd)
    det[:, 1] = rng.uniform(-30, 30, nd)
    det[:, 2] = rng.uniform(-2, 0, nd)
    det[:, 7] = 1.0  # cos(yaw)=1
    mapa = rng.uniform(-20, 20, (nm, npts, 2)).astype(np.float32)
    mapa.sort(axis=1)
    motion = np.cumsum(rng.randn(n_cls, fut_mode, fut_ts, 2).astype(np.float32), axis=2)
    step = rng.uniform(0.5, 2.5, (n_types * cmd * ego_mode, 1, 2)).astype(np.float32)
    plan = np.cumsum(np.tile(step, (1, ego_ts, 1)), axis=1)
    plan = plan.reshape(n_types * cmd * ego_mode, ego_ts * 2)
    return det, mapa.reshape(nm, -1), motion, plan


def load_anchors(kmeans_dir: str = REFERENCE_KMEANS_DIR, cfg_kwargs: dict | None = None):
    """Load (det, map, motion, plan) anchors; synthesise when files missing."""
    cfg_kwargs = cfg_kwargs or {}
    types = cfg_kwargs.get("plan_anchor_types", HiPADConfig.plan_anchor_types)
    paths = {
        "det": os.path.join(kmeans_dir, "b2d_det_900.npy"),
        "map": os.path.join(kmeans_dir, "b2d_map_100.npy"),
        "motion": os.path.join(kmeans_dir, "b2d_motion_6.npy"),
        "plan_2m": os.path.join(kmeans_dir, "b2d_plan_spat_6x8_2m.npy"),
        "plan_5m": os.path.join(kmeans_dir, "b2d_plan_spat_6x8_5m.npy"),
    }
    if all(os.path.exists(p) for p in paths.values()):
        det = np.load(paths["det"]).astype(np.float32)
        mapa = np.load(paths["map"]).astype(np.float32).reshape(100, -1)
        motion = np.load(paths["motion"]).astype(np.float32)
        plan_2m = np.load(paths["plan_2m"]).astype(np.float32).reshape(48, -1)
        plan_5m = np.load(paths["plan_5m"]).astype(np.float32).reshape(48, -1)
        # Per-anchor-type plan anchor table (stage2 config:88-99): 2m-spaced
        # anchors for 5hz/2m/speed-5hz groups, 5m-spaced for 2hz/5m/speed-2hz.
        per_type = []
        for t in types:
            unit = t[1]
            per_type.append(plan_2m if unit in ("5hz", "2m") else plan_5m)
        plan = np.concatenate(per_type, axis=0)
        return det, mapa, motion, plan
    return _synthetic_anchors(cfg_kwargs, np.random.RandomState(0))


def stage2(kmeans_dir: str = REFERENCE_KMEANS_DIR, **overrides) -> HiPADConfig:
    # convenience: num_temporal_layers=N builds the op program with N
    # temporal layers after the single-frame layer (perf slope probes)
    n_temp = overrides.pop("num_temporal_layers", None)
    if n_temp is not None:
        overrides["operation_order"] = (
            SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * n_temp)
    det, mapa, motion, plan = load_anchors(kmeans_dir, overrides)
    return HiPADConfig(
        det_anchor=det, map_anchor=mapa, motion_anchor=motion, plan_anchor=plan,
        **overrides,
    )


def stage1(kmeans_dir: str = REFERENCE_KMEANS_DIR, **overrides) -> HiPADConfig:
    """Perception pre-training: no motion task, single plan anchor type
    (stage1 config:67,85-87); plan/ego losses weighted 0 by the trainer."""
    overrides.setdefault("task_select", ("det", "map", "plan", "ego"))
    overrides.setdefault("plan_anchor_types", (("temp", "2hz"),))
    overrides.setdefault("plan_anchor_refer", ("temp", "2hz"))
    overrides.setdefault("plan_speed_refer", ("temp", "2hz"))
    return stage2(kmeans_dir, **overrides)


def stage2_serving(kmeans_dir: str = REFERENCE_KMEANS_DIR,
                   **overrides) -> HiPADConfig:
    """Serving configuration: stage-2 weights/semantics with the documented
    latency approximations enabled — weight-top-k keypoint pruning
    (renormalised, sampler_point_frac) on top of the renormalised cam_k=2
    default. The exact-semantics config remains ``stage2()``; error bounds
    for each knob live in tests/test_sampling.py."""
    overrides.setdefault("sampler_point_frac", 0.25)
    return stage2(kmeans_dir, **overrides)


def stage2_serving_topk(kmeans_dir: str = REFERENCE_KMEANS_DIR,
                        **overrides) -> HiPADConfig:
    """``stage2_serving`` plus the reference's own per-layer plan-mode
    pruning (`sparse_onedecoder.py:982-1007`, shipped upstream behind
    ``with_topk_mode`` but not enabled in its configs): keep the top-12 of
    48 plan modes per anchor group from refine layer 3 on, shrinking the
    live query set of layers 3-6 by 24% (its speed on the card: PERF.md);
    det/map outputs are bit-identical to
    ``stage2_serving`` (the pruning touches only plan queries), while the
    decoded plan trajectory can change whenever the pruning layer's score
    ranking disagrees with the final layer's — an effect the random-weight
    error sweep can only upper-bound (see README serving-accuracy table)."""
    overrides.setdefault("with_topk_mode", True)
    overrides.setdefault("topk_mode_list", (48, 48, 12, 12, 12, 12))
    overrides.setdefault("num_temp_plan_mode", 12)
    return stage2_serving(kmeans_dir, **overrides)


def stage2_serving_det(kmeans_dir: str = REFERENCE_KMEANS_DIR,
                       **overrides) -> HiPADConfig:
    """``stage2_serving`` plus det-query pruning only — the round-5
    production headline. Rationale (trained-weights sweep,
    tools/serving_error_sweep.py --load-from, README round-5 table):
    det pruning ranks by the banks' PERSISTENT decayed confidence and
    measured nearly free on the decoded plan trajectory (0.02 m L2, zero
    winner flips), while the plan-mode knob (``with_topk_mode``) ranks by
    the CURRENT layer's score and still cost 0.53 m plan L2 on the same
    checkpoint — so only the measured-safe knob is promoted; the faster
    ``stage2_serving_topk`` / ``stage2_serving_prune`` variants remain
    opt-in pending real-checkpoint retention validation. Its speed on the
    card: PERF.md."""
    overrides.setdefault("with_topk_det", True)
    overrides.setdefault("topk_det_list", (900, 900, 450, 450, 450, 450))
    return stage2_serving(kmeans_dir, **overrides)


def stage2_serving_prune(kmeans_dir: str = REFERENCE_KMEANS_DIR,
                         **overrides) -> HiPADConfig:
    """``stage2_serving_topk`` plus det-query pruning: keep the top-450 of
    900 det queries (by the banks' own confidence ranking — decayed cache
    confidence for the temporal segment, single-frame merge confidence for
    the fresh segment) from refine layer 3 on. Layers 3-6 then run 1031
    live queries instead of 1481 (det 300+150, map 100, plan 120, ego 1):
    the two structural pruning knobs together cut attention, sampling and
    refinement work on both large query groups. Dropped det instances
    freeze at their layer-2 state and remain visible to the temporal bank,
    the tracker and the det output exactly as non-improving detections
    (see HiPADConfig.with_topk_det). Accuracy deltas quantified per-knob in
    the serving error sweep (README)."""
    overrides.setdefault("with_topk_det", True)
    overrides.setdefault("topk_det_list", (900, 900, 450, 450, 450, 450))
    return stage2_serving_topk(kmeans_dir, **overrides)


def stage2_r101_2x(kmeans_dir: str = REFERENCE_KMEANS_DIR,
                   **overrides) -> HiPADConfig:
    """Scaled-backbone config (BASELINE.json configs[4]): ResNet101 (stage
    blocks 3-4-23-3) at 2x stage 2's input in each dimension. Quadruples
    every feature-map level's HW, which stresses the trunk and the FPN; the
    sampler's taps, and so its time, do not grow with the maps, and the
    decoder's query structure is unchanged."""
    overrides.setdefault("backbone_stage_blocks", (3, 4, 23, 3))
    overrides.setdefault("input_size", (704, 1280))
    return stage2(kmeans_dir, **overrides)


def tiny(**overrides) -> HiPADConfig:
    """Small config for CPU tests: same structure, tiny widths/counts."""
    kwargs = dict(
        embed_dims=32,
        num_groups=4,
        num_cams=2,
        input_size=(64, 96),
        backbone_stage_blocks=(1, 1, 1, 1),
        backbone_base_planes=8,
        backbone_remat=False,
        num_det_anchor=12,
        num_temp_det_anchor=6,
        num_map_anchor=4,
        map_num_pts=5,
        map_kps=PointKeypointSpec(5, 2, (0.0, 0.5), GROUND_HEIGHT),
        plan_kps=PointKeypointSpec(4, 2, (0.0, 0.5), GROUND_HEIGHT),
        det_kps=KeypointSpec(((0.0, 0.0, 0.0), (0.45, 0.0, 0.0)), 2),
        ego_kps=KeypointSpec(((0.45, 0.0, 0.0),), 3),
        ego_fut_ts=4,
        ego_fut_mode=3,
        num_temp_plan_mode=3,
        fut_ts=4,
        fut_mode=2,
        plan_anchor_types=(
            ("temp", "5hz"), ("spat", "2m"),
            ("speed", "5hz", (0.0, 3.0)), ("speed", "5hz", (3.0, 999.0)),
        ),
        plan_anchor_refer=("spat", "2m"),
        plan_speed_refer=("temp", "5hz"),
        operation_order=SINGLE_FRAME_LAYER + TEMPORAL_FRAME_LAYER * 1,
    )
    kwargs.update(overrides)
    det, mapa, motion, plan = _synthetic_anchors(kwargs, np.random.RandomState(0))
    return HiPADConfig(det_anchor=det, map_anchor=mapa, motion_anchor=motion,
                       plan_anchor=plan, **kwargs)


def aug_conf_for(input_size: Sequence[int]) -> Dict:
    """The stage-2 augmentation at a model's ``input_size`` (H, W):
    ``pipelines.DATA_AUG_CONF`` itself at its own ``final_dim``; at another
    size the resize range is scaled so that the resized image still covers
    the crop, and the test-time resize and crop follow from ``final_dim``
    (``pipelines.sample_aug_config``: 704x1280 -> 0.8, (0, 16, 1280, 720))."""
    base = pp.DATA_AUG_CONF
    fh, fw = input_size
    if (fh, fw) == tuple(base["final_dim"]):
        return base
    s = max(fh / base["final_dim"][0], fw / base["final_dim"][1])
    return dict(base, final_dim=(fh, fw), resize_lim=tuple(r * s for r in base["resize_lim"]))
