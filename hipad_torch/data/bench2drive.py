"""Bench2Drive dataset: pkl infos -> padded per-frame training dicts.

TPU rework of the reference ``Bench2DriveDataset``
(`datasets/bench2drive_dataset.py:141-1156`). Behaviour-matching pieces:

  * CARLA->class ``NAME_MAPPING`` and box remap (lwh swap + yaw flip,
    `bench2drive_dataset.py:843-857`);
  * ``split_group=5`` frame interleaving: the 10 Hz source stream is split
    into 5 strided groups so consecutive dataset indices are 0.5 s apart
    (`:232-242`); "next frame" arithmetic walks the groups (`:451-467`);
  * ego temporal trajectories at arbitrary Hz and ego *spatial* waypoints at
    uniform arc-length / LID spacing with polynomial-fit densification
    (`:445-595`);
  * agent future tracks with abnormal-acceleration filtering (`:597-643`);
  * map polylines from the town lane graph with recursive lane-topology
    connection (`connect_lanes`, `:331-406`) and ROI clipping (`:952-1106`);
  * ego status / command one-hot / far & near target points rotated into the
    ego frame (`:888-942`).

Differences by design: output GT is *padded to fixed capacity* with validity
masks (`pipelines.pad_gt_frame`) so every training batch has static shapes.
"""

from __future__ import annotations

import math
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.model import DET_CLASS_NAMES, MAP_CLASS_NAMES
from . import native
from . import pipelines as pp

# CARLA actor type -> detection class (`bench2drive_dataset.py:27-118`).
NAME_MAPPING = {}
for _t in ("bh.crossbike", "diamondback.century", "gazelle.omafiets"):
    NAME_MAPPING[f"vehicle.{_t}"] = "bicycle"
for _t in (
    "audi.etron", "chevrolet.impala", "dodge.charger_2020",
    "dodge.charger_police", "dodge.charger_police_2020", "lincoln.mkz_2017",
    "lincoln.mkz_2020", "mini.cooper_s_2021", "mercedes.coupe_2020",
    "ford.mustang", "nissan.patrol_2021", "audi.tt", "ford.crown",
    "tesla.model3",
):
    NAME_MAPPING[f"vehicle.{_t}"] = "car"
for _p, _c in (
    ("FordCrown/SM_FordCrown_parked.SM_FordCrown_parked", "car"),
    ("Charger/SM_ChargerParked.SM_ChargerParked", "car"),
    ("Lincoln/SM_LincolnParked.SM_LincolnParked", "car"),
    ("MercedesCCC/SM_MercedesCCC_Parked.SM_MercedesCCC_Parked", "car"),
    ("Mini2021/SM_Mini2021_parked.SM_Mini2021_parked", "car"),
    ("NissanPatrol2021/SM_NissanPatrol2021_parked.SM_NissanPatrol2021_parked", "car"),
    ("TeslaM3/SM_TeslaM3_parked.SM_TeslaM3_parked", "car"),
    ("VolkswagenT2/SM_VolkswagenT2_2021_Parked.SM_VolkswagenT2_2021_Parked", "van"),
):
    NAME_MAPPING[
        f"/Game/Carla/Static/Car/4Wheeled/ParkedVehicles/{_p}"
    ] = _c
NAME_MAPPING["vehicle.ford.ambulance"] = "van"
NAME_MAPPING["vehicle.carlamotors.firetruck"] = "truck"
for _s in ("30", "40", "50", "60", "90", "120"):
    NAME_MAPPING[f"traffic.speed_limit.{_s}"] = "traffic_sign"
NAME_MAPPING["traffic.stop"] = "traffic_sign"
NAME_MAPPING["traffic.yield"] = "traffic_sign"
NAME_MAPPING["traffic.traffic_light"] = "traffic_light"
for _t in ("warningconstruction", "warningaccident", "trafficwarning",
           "constructioncone"):
    NAME_MAPPING[f"static.prop.{_t}"] = "traffic_cone"
for _i in (1, 3, 4, 5, 7, 10, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 25, 27,
           30, 31, 32, 34, 35, 41, 42, 46, 47):
    NAME_MAPPING[f"walker.pedestrian.{_i:04d}"] = "pedestrian"
NAME_MAPPING["static.prop.dirtdebris01"] = "others"
NAME_MAPPING["static.prop.dirtdebris02"] = "others"


def invert_pose(pose: np.ndarray) -> np.ndarray:
    inv = np.eye(4)
    inv[:3, :3] = pose[:3, :3].T
    inv[:3, 3] = -inv[:3, :3] @ pose[:3, 3]
    return inv


def command2hot(command: int, max_dim: int = 6) -> np.ndarray:
    """LEFT/RIGHT/STRAIGHT/LANE FOLLOW/CHANGE LEFT/CHANGE RIGHT one-hot
    (`bench2drive_dataset.py:322-329`)."""
    if command < 0:
        command = 4
    out = np.zeros(max_dim, np.float32)
    out[command - 1] = 1.0
    return out


class Bench2DriveDataset:
    """Frame-level dataset over ``b2d_infos_{train,val}.pkl``."""

    def __init__(
        self,
        ann_file: str,
        map_file: Optional[str] = None,
        data_root: str = "data/bench2drive",
        det_classes: Sequence[str] = DET_CLASS_NAMES,
        map_classes: Sequence[str] = MAP_CLASS_NAMES,
        plan_anchor_types: Sequence = (("temp", "5hz"), ("spat", "2m"),
                                       ("temp", "2hz"), ("spat", "5m")),
        split_group: int = 5,
        sequences_split_num: int = 2,
        test_mode: bool = False,
        data_aug_conf: Dict = pp.DATA_AUG_CONF,
        point_cloud_range=(-15.0, -30.0, -2.0, 15.0, 30.0, 2.0),
        future_frames: int = 6,
        spatial_points: int = 6,
        sample_rate: int = 1,
        remap_box: bool = True,
        with_connect_lane: bool = True,
        keep_consistent_seq_aug: bool = True,
        num_depth_levels: int = 3,
        strides: Sequence[int] = (4, 8, 16),
        max_gt_boxes: int = pp.MAX_GT_BOXES,
        max_gt_map: int = pp.MAX_GT_MAP,
    ):
        self.data_root = data_root
        self.det_classes = list(det_classes)
        self.map_classes = list(map_classes)
        self.map_element_class = {c: i for i, c in enumerate(self.map_classes)}
        self.plan_anchor_types = [tuple(t) for t in plan_anchor_types]
        self.split_group = split_group
        self.test_mode = test_mode
        self.data_aug_conf = data_aug_conf
        self.pc_range = np.asarray(point_cloud_range)
        self.future_frames = future_frames
        self.spatial_points = spatial_points
        self.sample_rate = sample_rate
        self.remap_box = remap_box
        self.with_connect_lane = with_connect_lane
        self.keep_consistent_seq_aug = keep_consistent_seq_aug
        self.strides = list(strides)[:num_depth_levels]
        self.max_gt_boxes = max_gt_boxes
        self.max_gt_map = max_gt_map

        with open(ann_file, "rb") as f:
            self.data_infos = pickle.load(f)
        if isinstance(self.data_infos, dict) and "infos" in self.data_infos:
            self.data_infos = self.data_infos["infos"]
        # CARLA actor type -> detection class (`bench2drive_dataset.py:761-765`)
        for info in self.data_infos:
            info["gt_names"] = np.array(
                [NAME_MAPPING.get(n, n) for n in info["gt_names"]]
            )
        self.map_infos = {}
        if map_file and osp.exists(map_file):
            with open(map_file, "rb") as f:
                self.map_infos = pickle.load(f)

        if self.split_group > 0:
            self._split_data_infos()
        self._set_sequence_group_flag(sequences_split_num)

    # ---- frame ordering --------------------------------------------------

    def _split_data_infos(self):
        """Interleave the 10 Hz stream into ``split_group`` strided groups so
        consecutive indices are split_group/10 s apart (`:232-242`)."""
        groups = [self.data_infos[i::self.split_group] for i in range(self.split_group)]
        self.group_length = np.array([len(g) for g in groups])
        self.group_cumsum = np.array([0] + list(self.group_length[:-1])).cumsum()
        self.data_infos = [x for g in groups for x in g]

    def _set_sequence_group_flag(self, sequences_split_num: int):
        """Sequence ids for the sampler (`:244-296`)."""
        res, cur = [], 0
        for i in range(len(self.data_infos)):
            if i != 0 and self.data_infos[i]["folder"] != self.data_infos[i - 1]["folder"]:
                cur += 1
            res.append(cur)
        flag = np.array(res, np.int64)
        if sequences_split_num > 1:
            bins = np.bincount(flag)
            new, nf = [], 0
            for b in bins:
                cuts = list(range(0, b, math.ceil(b / sequences_split_num))) + [b]
                for ln in np.diff(cuts):
                    new.extend([nf] * ln)
                    nf += 1
            flag = np.array(new, np.int64)
        self.flag = flag

    def __len__(self):
        return len(self.data_infos)

    def _next_index(self, idx: int) -> int:
        """Step to the chronologically-next frame across strided groups
        (`:451-467`)."""
        if self.split_group <= 0:
            return idx + 1
        diffs = idx - self.group_cumsum
        diffs = np.where(diffs < 0, len(self.data_infos), diffs)
        g = int(np.argmin(diffs))
        d = int(diffs[g])
        if g >= self.split_group - 1:
            return int(self.group_cumsum[0] + d + 1)
        return int(self.group_cumsum[g + 1] + d)

    # ---- ego future (temporal) --------------------------------------------

    def get_ego_temporal_trajs(self, idx: int, future_frames: int, interval: int = 1):
        """Per-step ego xy offsets at 1/(0.5s*interval) Hz (`:445-500`)."""
        adj = [idx]
        a = idx
        for _ in range(future_frames * interval):
            a = self._next_index(a)
            adj.append(a)
        adj = adj[::interval]

        cur = self.data_infos[idx]
        track = np.zeros((future_frames + 1, 2))
        mask = np.zeros(future_frames + 1)
        w2l_cur = cur["sensors"]["LIDAR_TOP"]["world2lidar"]
        past_idx = adj[0] - 2
        if 0 <= past_idx and self.data_infos[past_idx]["folder"] == cur["folder"]:
            for j, a in enumerate(adj):
                if not (0 <= a < len(self.data_infos)):
                    continue
                fr = self.data_infos[a]
                if fr["folder"] != cur["folder"]:
                    break
                rel = w2l_cur @ np.linalg.inv(fr["sensors"]["LIDAR_TOP"]["world2lidar"])
                track[j] = rel[0:2, 3]
                mask[j] = 1
        offsets = track[1:] - track[:-1]
        offsets[mask[1:] == 0] = 0
        return offsets.astype(np.float32), mask[1:].astype(np.float32)

    # ---- ego future (spatial) ----------------------------------------------

    def get_ego_spatial_trajs(self, idx: int, sample_points: int, strategy: Dict,
                              with_fitting: bool = False):
        """Waypoints at fixed arc-length spacings (`:502-595`)."""
        if strategy["mode"] == "LID":
            s0, s1 = strategy["start_distance"], strategy["end_distance"]
            i = np.arange(sample_points)
            bin_size = (s1 - s0) / (sample_points * (1 + sample_points))
            dists = s0 + bin_size * i * (i + 1)
        elif strategy["mode"] == "uniform":
            d = strategy["sample_distance"]
            dists = np.array([k * d for k in range(1, sample_points + 1)])
        else:
            raise NotImplementedError(strategy["mode"])

        cur = self.data_infos[idx]
        w2l_cur = cur["sensors"]["LIDAR_TOP"]["world2lidar"]
        positions = []
        a = idx
        # The group-walk index arithmetic can alias between groups at sequence
        # ends (same as upstream); real datasets terminate on the folder
        # change — the step bound makes single-sequence data safe too.
        for _ in range(len(self.data_infos)):
            a = self._next_index(a)
            if not (0 <= a < len(self.data_infos)):
                break
            fr = self.data_infos[a]
            if fr["folder"] != cur["folder"]:
                break
            rel = w2l_cur @ np.linalg.inv(fr["sensors"]["LIDAR_TOP"]["world2lidar"])
            positions.append(rel[0:2, 3])
        positions = np.array(positions)

        mask = np.zeros(sample_points, np.float32)
        trajs = np.full((sample_points, 2), -1.0, np.float32)
        offsets = np.full((sample_points, 2), -1.0, np.float32)

        if with_fitting and len(positions) > 1:
            # polynomial densification (`:560-580`): fit y(x) of the path with
            # the best of degree 1..3, resample 10x.
            from numpy.polynomial import Polynomial

            x, y = positions[:, 1], positions[:, 0]
            best, best_err = None, np.inf
            for deg in range(1, 4):
                try:
                    p = Polynomial.fit(x, y, deg)
                except Exception:
                    continue
                err = np.linalg.norm(p(x) - y)
                if err < best_err:
                    best, best_err = p, err
            if best is not None:
                xf = np.linspace(np.min(x), np.max(x), len(x) * 10)
                yf = best(xf)
                if abs(yf[0] - positions[0][0]) < 0.1:
                    positions = np.stack([yf, xf], axis=1)

        prev = -1
        if len(positions) > 0:
            radii = np.linalg.norm(positions, axis=1)
            for si, sd in enumerate(dists):
                pre = dists[si] if si == 0 else dists[si] - dists[si - 1]
                diff = np.abs(sd - radii)
                mi = int(np.argmin(diff))
                if mi > prev and diff[mi] < pre * 0.25:
                    trajs[si] = positions[mi]
                    mask[si] = 1
                    prev = mi
            for i in range(sample_points):
                if mask[i]:
                    offsets[i] = trajs[i] if i == 0 else trajs[i] - trajs[i - 1]
                    if np.linalg.norm(offsets[i]) < 0.1:
                        offsets[i] = (-1, -1)
                        mask[i] = 0
        return offsets, mask

    # ---- agent futures ------------------------------------------------------

    def get_agent_trajs(self, idx: int, future_frames: int, sample_rate: int):
        """Per-agent xy offset tracks with abnormal-accel filtering (`:597-643`)."""
        cur = self.data_infos[idx]
        ids = cur["gt_ids"]
        w2l = cur["sensors"]["LIDAR_TOP"]["world2lidar"]
        n = len(cur["gt_boxes"])
        track = np.zeros((n, future_frames + 1, 2))
        mask = np.zeros((n, future_frames + 1))
        fut_idx = range(idx, idx + (future_frames + 1) * sample_rate, sample_rate)
        for i, cid in enumerate(ids):
            for j, fi in enumerate(fut_idx):
                if not (0 <= fi < len(self.data_infos)):
                    continue
                fr = self.data_infos[fi]
                if fr["folder"] != cur["folder"]:
                    break
                hit = np.where(fr["gt_ids"] == cid)[0]
                if len(hit) == 0:
                    continue
                rel = w2l @ fr["npc2world"][hit[0]]
                track[i, j] = rel[0:2, 3]
                mask[i, j] = 1
        off = track[:, 1:] - track[:, :-1]
        m = mask[:, 1:]
        # abnormal acceleration filter (`:630-643`)
        dt = 10 / self.split_group if self.split_group > 0 else 10
        vel = np.linalg.norm(off / dt, axis=2)
        vel = np.concatenate([np.zeros_like(vel[:, :1]), vel], axis=1)
        acc = np.abs(vel[:, 1:] - vel[:, :-1] / dt)
        for i, a in enumerate(acc):
            bad = np.where(a > 5)[0]
            if len(bad):
                b = bad.min()
                off[i, b:] = -1
                m[i, b:] = 0
        return off.astype(np.float32), m.astype(np.float32)

    def get_box_attr_labels(self, idx: int, frames: int) -> np.ndarray:
        """34+-d agent attribute labels for eval (`:645-707`)."""
        cur = self.data_infos[idx]
        ids = cur["gt_ids"]
        boxes = cur["gt_boxes"]
        names = cur["gt_names"]
        w2l = cur["sensors"]["LIDAR_TOP"]["world2lidar"]
        n = len(ids)
        track = np.zeros((n, frames + 1, 2))
        mask = np.zeros((n, frames + 1))
        yaw = np.zeros((n, frames + 1))
        goal = np.zeros((n, 1))
        lcf = np.zeros((n, 9))
        adj_idx = range(idx, idx + (frames + 1) * self.sample_rate, self.sample_rate)
        for i in range(n):
            lcf[i, 0:2] = boxes[i, 0:2]
            lcf[i, 2] = boxes[i, 6]
            lcf[i, 3:5] = boxes[i, 7:9]
            lcf[i, 5:8] = boxes[i, 3:6]
            lcf[i, 8] = (self.det_classes.index(names[i])
                         if names[i] in self.det_classes else -1)
            for j, a in enumerate(adj_idx):
                if not (0 <= a < len(self.data_infos)):
                    break
                fr = self.data_infos[a]
                if fr["folder"] != cur["folder"]:
                    break
                hit = np.where(fr["gt_ids"] == ids[i])[0]
                if len(hit) == 0:
                    continue
                rel = w2l @ fr["npc2world"][hit[0]]
                track[i, j] = rel[0:2, 3]
                mask[i, j] = 1
                yaw[i, j] = np.arctan2(rel[1, 0], rel[0, 0])
            diff = track[i, -1] - track[i, 0]
            if diff.max() < 1.0:
                goal[i] = 9
            else:
                goal[i] = (np.arctan2(diff[1], diff[0]) + np.pi) // (np.pi / 4)
        off = track[:, 1:] - track[:, :-1]
        moff = mask[:, 1:]
        off[moff == 0] = 0
        dyaw = yaw[:, 1:] - yaw[:, :-1]
        dyaw[dyaw > np.pi] -= 2 * np.pi
        dyaw[dyaw < -np.pi] += 2 * np.pi
        return np.concatenate(
            [off.reshape(n, frames * 2), moff, goal, lcf, dyaw], axis=-1
        ).astype(np.float32)

    # ---- map ---------------------------------------------------------------

    def _connect_lanes(self, lines: List, line_ids: List, target_ids: List):
        """Merge lane fragments along the topology graph (`:331-406`)."""
        index, it = 0, 0
        stop = True
        while True:
            if index >= len(lines):
                it += 1
                if it >= 1000 or stop:
                    break
                index, stop = 0, True
            line_list = list(lines[index])
            id_list = list(line_ids[index])
            tgt = target_ids[index]
            merged = False
            for ti, t_ids in enumerate(line_ids):
                if ti == index:
                    continue
                if tgt[0] in [x[0] for x in id_list]:
                    continue
                if tgt == t_ids[0]:
                    t_lines = lines[ti]
                    if np.linalg.norm(t_lines[0][0] - line_list[-1][-1]) < 0.1:
                        line_list = line_list + list(t_lines)
                        id_list = id_list + list(t_ids)
                        lines[ti] = line_list
                        line_ids[ti] = id_list
                        merged = True
                elif tgt in t_ids:
                    si = t_ids.index(tgt)
                    t_lines = lines[ti]
                    if np.linalg.norm(t_lines[si][0] - line_list[-1][-1]) < 0.1:
                        nl = line_list + list(t_lines[si:])
                        ni = id_list + list(t_ids[si:])
                        if ni != t_ids:
                            lines.append(nl)
                            line_ids.append(ni)
                            target_ids.append(target_ids[ti])
                            merged = True
            if merged:
                stop = False
                lines.pop(index)
                line_ids.pop(index)
                target_ids.pop(index)
            else:
                index += 1
        # dedup identical chains (`:389-405`)
        i = 0
        while i < len(lines):
            j = i + 1
            while j < len(lines):
                if (len(line_ids[i]) == len(line_ids[j])
                        and line_ids[i] == line_ids[j]):
                    p1 = np.concatenate(lines[i])
                    p2 = np.concatenate(lines[j])
                    if len(p1) == len(p2) and (p1 == p2).all():
                        lines.pop(j)
                        line_ids.pop(j)
                        target_ids.pop(j)
                        continue
                j += 1
            i += 1
        return lines, line_ids, target_ids

    def get_map_polylines(self, idx: int) -> Tuple[List[np.ndarray], List[int]]:
        """Town map -> ego-frame clipped polylines + labels (`:952-1106`)."""
        info = self.data_infos[idx]
        if not self.map_infos:
            return [], []
        town = self.map_infos[info["town_name"]]
        w2l = np.array(info["sensors"]["LIDAR_TOP"]["world2lidar"])
        ego_xy = np.linalg.inv(w2l)[0:2, 3]
        max_distance = 50.0

        polylines: List[np.ndarray] = []
        labels: List[int] = []

        def clip_and_add(points_world: np.ndarray, label: int):
            pts = np.concatenate(
                [points_world, np.ones((len(points_world), 1))], axis=-1
            )
            in_lidar = (w2l @ pts.T).T
            m = ((in_lidar[:, 0] > self.pc_range[0]) & (in_lidar[:, 0] < self.pc_range[3])
                 & (in_lidar[:, 1] > self.pc_range[1]) & (in_lidar[:, 1] < self.pc_range[4]))
            change = np.diff(m.astype(int))
            starts = list(np.where(change == 1)[0] + 1)
            ends = list(np.where(change == -1)[0] + 1)
            if len(m) and m[0]:
                starts = [0] + starts
            if len(m) and m[-1]:
                ends = ends + [len(m)]
            for s, e in zip(starts, ends):
                seg = in_lidar[s:e, 0:2]
                if len(seg) > 1:
                    polylines.append(seg.astype(np.float32))
                    labels.append(label)

        lane_types = town["lane_types"]
        lane_points = town["lane_points"]
        lane_sample_points = town["lane_sample_points"]
        if self.with_connect_lane and "lane_ids" in town:
            lane_ids, lane_topos = town["lane_ids"], town["lane_topos"]
            for lane_type, label in self.map_element_class.items():
                lines, ids, tgts = [], [], []
                for i in range(len(lane_sample_points)):
                    d = np.linalg.norm(lane_sample_points[i][:, 0:2] - ego_xy, axis=-1)
                    if d.min() < max_distance and lane_types[i] == lane_type:
                        if lane_type == "Center":
                            lines.append([np.array(lane_points[i])])
                        else:
                            for tgt in lane_topos[i]:
                                lines.append([np.array(lane_points[i])])
                                ids.append([lane_ids[i]])
                                tgts.append(tgt)
                if lines and lane_type != "Center":
                    lines, ids, tgts = self._connect_lanes(lines, ids, tgts)
                for chain in lines:
                    clip_and_add(np.concatenate(chain)[:, :3], label)
        else:
            for i in range(len(lane_sample_points)):
                if lane_types[i] not in self.map_element_class:
                    continue
                d = np.linalg.norm(lane_sample_points[i][:, 0:2] - ego_xy, axis=-1)
                if d.min() < max_distance:
                    clip_and_add(np.array(lane_points[i])[:, :3],
                                 self.map_element_class[lane_types[i]])

        # trigger volumes (stop signs / traffic lights) — closed polygons
        for i in range(len(town.get("trigger_volumes_points", []))):
            t = town["trigger_volumes_types"][i]
            if t not in self.map_element_class:
                continue
            pts = np.array(town["trigger_volumes_points"][i])
            ptsh = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1)
            in_lidar = (w2l @ ptsh.T).T
            m = ((in_lidar[:, 0] > self.pc_range[0]) & (in_lidar[:, 0] < self.pc_range[3])
                 & (in_lidar[:, 1] > self.pc_range[1]) & (in_lidar[:, 1] < self.pc_range[4]))
            if m.all():
                closed = np.concatenate([in_lidar[:, 0:2], in_lidar[0:1, 0:2]])
                polylines.append(closed.astype(np.float32))
                labels.append(self.map_element_class[t])
        return polylines, labels

    # ---- full frame -------------------------------------------------------

    def get_data_info(self, index: int) -> Dict:
        info = self.data_infos[index]
        lidar2ego = info["sensors"]["LIDAR_TOP"]["lidar2ego"]
        lidar2global = invert_pose(info["sensors"]["LIDAR_TOP"]["world2lidar"])
        img_paths, lidar2img, intrinsics = [], [], []
        for name, cam in info["sensors"].items():
            if "CAM" not in name:
                continue
            intr = np.eye(4)
            intr[: cam["intrinsic"].shape[0], : cam["intrinsic"].shape[1]] = cam["intrinsic"]
            ego2cam = invert_pose(cam["cam2ego"])
            lidar2img.append(intr @ ego2cam @ lidar2ego)
            intrinsics.append(intr)
            img_paths.append(osp.join(self.data_root, cam["data_path"]))
        return dict(
            folder=info["folder"],
            scene_token=info["folder"],
            frame_idx=info["frame_idx"],
            timestamp=info["frame_idx"] / 10,
            img_filename=img_paths,
            lidar2img=np.stack(lidar2img).astype(np.float32),
            cam_intrinsic=np.stack(intrinsics).astype(np.float32),
            lidar2global=lidar2global.astype(np.float32),
            pts_filename=osp.join(self.data_root, info["folder"],
                                  "lidar/{:05}.laz".format(info["frame_idx"])),
        )

    def get_ann_info(self, index: int) -> Dict:
        info = self.data_infos[index]
        out: Dict = {}

        mask = info["num_points"] != 0
        names = info["gt_names"][mask]
        boxes = info["gt_boxes"][mask].copy()
        labels = np.array(
            [self.det_classes.index(n) if n in self.det_classes else -1 for n in names]
        )
        if self.remap_box:
            # lwh swap + yaw remap into the nuScenes-style frame (`:843-857`)
            tmp = boxes[:, 3].copy()
            boxes[:, 3] = boxes[:, 4]
            boxes[:, 4] = tmp
            boxes[:, 6] = -(boxes[:, 6] + np.pi / 2)
        out["gt_names"] = names
        out["gt_labels_3d"] = labels
        out["gt_bboxes_3d"] = boxes
        out["instance_inds"] = np.array(info["gt_ids"][mask], np.int32)
        out["gt_attr_labels"] = self.get_box_attr_labels(index, self.future_frames)[mask]

        trajs, tmask = self.get_agent_trajs(index, self.future_frames, self.sample_rate)
        out["gt_agent_fut_trajs"] = trajs[mask]
        out["gt_agent_fut_masks"] = tmask[mask]

        polylines, plabels = self.get_map_polylines(index)
        out["map_polylines"] = polylines
        out["map_labels"] = plabels

        out.update(self.get_plan_info(index))

        status = np.zeros(6, np.float32)
        status[0] = info["ego_vel"][0]
        status[1:3] = info["ego_accel"][:2]
        status[3:5] = info["ego_rotation_rate"][:2]
        status[5] = info["steer"]
        out["ego_status"] = status
        limit_vel = 20.0
        limit_accel = limit_vel / (0.1 * max(self.split_group, 1))
        smask = np.ones(6, np.float32)
        if info["ego_vel"][0] > limit_vel:
            smask[0] = 0.0
        if np.linalg.norm(info["ego_accel"][:2]) > limit_accel:
            smask[1:3] = 0.0
        out["ego_status_mask"] = smask

        out["gt_ego_fut_cmd"] = command2hot(info["command_near"])
        theta = -(info["ego_yaw"] - np.pi / 2)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        far = info["command_far_xy"] - info["ego_translation"][:2]
        near = info["command_near_xy"] - info["ego_translation"][:2]
        out["target_point"] = np.array(rot @ far, np.float32)
        out["target_point_near"] = np.array(rot @ near, np.float32)
        return out

    def get_plan_info(self, index: int) -> Dict:
        """Per-anchor-type ego future GT (`:1108-1145`)."""
        out: Dict = {}
        for t in self.plan_anchor_types:
            if t[0] == "temp" or (t[0] == "speed" and
                                  f"gt_ego_fut_trajs_{t[1]}" not in out):
                hz = float(t[1].split("hz")[0])
                interval = int(10 // hz)
                trajs, masks = self.get_ego_temporal_trajs(
                    index, self.future_frames, interval
                )
                out[f"gt_ego_fut_trajs_{t[1]}"] = trajs
                out[f"gt_ego_fut_masks_{t[1]}"] = masks
                if t[1] == "2hz":
                    out["gt_ego_fut_trajs"] = trajs
                    out["gt_ego_fut_masks"] = masks
        for t in self.plan_anchor_types:
            if t[0] != "spat":
                continue
            if t[1].endswith("m") and "lid" not in t[1]:
                strategy = dict(mode="uniform",
                                sample_distance=float(t[1][:-1]))
            elif "lid" in t[1]:
                area = t[1].split("lid_")[1].split("_")
                strategy = dict(mode="LID",
                                start_distance=float(area[0][:-1]),
                                end_distance=float(area[1][:-1]))
            else:
                raise NotImplementedError(t)
            trajs, masks = self.get_ego_spatial_trajs(index, self.spatial_points, strategy)
            out[f"gt_ego_spat_trajs_{t[1]}"] = trajs
            out[f"gt_ego_spat_masks_{t[1]}"] = masks
        return out

    # ---- assembled frame ----------------------------------------------------

    def load_lidar_points(self, pts_filename: str) -> Optional[np.ndarray]:
        """LiDAR points for the aux depth GT (`pipelines/loading.py`,
        ``B2DLoadPointsFromFile``: laspy .laz files). Returns None when the
        file or laspy is unavailable — the depth loss then just skips."""
        if not osp.exists(pts_filename):
            return None
        try:
            import laspy  # optional dependency

            with laspy.open(pts_filename) as f:
                las = f.read()
            return np.stack([las.x, las.y, las.z], axis=1).astype(np.float32)
        except ImportError:
            return None

    def load_images(self, paths: Sequence[str]) -> np.ndarray:
        """Load to BGR float32 [cams, H, W, 3] (mmcv-imread convention).
        A file that is absent loads as zeros; one that exists is decoded
        with PIL, and without PIL that raises."""
        imgs = []
        for p in paths:
            if osp.exists(p):
                try:
                    from PIL import Image
                except ImportError as e:
                    raise ImportError(f"{p} exists, but PIL, which decodes it, cannot be "
                                      "imported") from e

                rgb = np.asarray(Image.open(p).convert("RGB"), np.float32)
                imgs.append(rgb[..., ::-1])
            else:
                conf = self.data_aug_conf
                imgs.append(np.zeros((conf["H"], conf["W"], 3), np.float32))
        return np.stack(imgs)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        aug_config = None
        distortion = None
        if isinstance(idx, dict):
            aug_config = idx.get("aug_config")
            distortion = idx.get("distortion")
            idx = idx["idx"]
        if aug_config is None:
            aug_config = pp.sample_aug_config(self.data_aug_conf,
                                              test_mode=self.test_mode)
        data = self.get_data_info(idx)
        data.update(self.get_ann_info(idx))

        imgs = self.load_images(data["img_filename"])
        # Native fused path (resize+crop+flip+normalize in C++) when no
        # photometric distortion / rotation is active; numpy otherwise.
        use_native = (self.test_mode or distortion is None) and not aug_config.get("rotate")
        native_out = (
            native.preprocess_cameras(imgs.astype(np.uint8), aug_config)
            if use_native else None
        )
        lidar2img = (pp.img_transform_matrix(aug_config)[None]
                     @ data["lidar2img"]).astype(np.float32)
        if native_out is not None:
            imgs = native_out
        else:
            imgs, _ = pp.resize_crop_flip(imgs, data["lidar2img"], aug_config)
            if not self.test_mode and distortion is not None:
                imgs = pp.photometric_distortion(imgs, distortion)
            imgs = pp.normalize_image(imgs)

        boxes, labels, extras = pp.circle_range_filter(
            data["gt_bboxes_3d"], data["gt_labels_3d"],
            [data["gt_agent_fut_trajs"], data["gt_agent_fut_masks"],
             data["gt_attr_labels"], data["instance_inds"]],
        ) if not self.test_mode else pp.bev_range_filter(
            data["gt_bboxes_3d"], data["gt_labels_3d"],
            [data["gt_agent_fut_trajs"], data["gt_agent_fut_masks"],
             data["gt_attr_labels"], data["instance_inds"]],
            self.pc_range,
        )
        keep = labels >= 0  # InstanceNameFilter
        boxes, labels = boxes[keep], labels[keep]
        extras = [e[keep] for e in extras]
        boxes[:, 6] = pp.limit_period(boxes[:, 6])

        map_labels, map_pts = pp.vectorize_polylines(
            data["map_polylines"], data["map_labels"], num_pts=20
        )

        h, w = imgs.shape[1:3]
        depth_keys = {}
        if not self.test_mode and self.strides:
            points = self.load_lidar_points(data["pts_filename"])
            if points is not None:
                maps = native.depth_maps(points, lidar2img, (h, w), self.strides)
                if maps is None:
                    maps = pp.multiscale_depth_maps(points, lidar2img, (h, w),
                                                    self.strides)
                depth_keys = {f"gt_depth_{i}": m for i, m in enumerate(maps)}

        frame = {
            "images": imgs,
            **depth_keys,
            "timestamp": np.float32(data["timestamp"]),
            "projection_mat": lidar2img,
            "image_wh": np.tile(np.array([w, h], np.float32), (len(lidar2img), 1)),
            "T_global": data["lidar2global"],
            "T_global_inv": np.linalg.inv(data["lidar2global"]).astype(np.float32),
            "focal": data["cam_intrinsic"][:, 0, 0] * aug_config["resize"],
            "gt_labels_3d": labels,
            "gt_bboxes_3d": boxes,
            "gt_agent_fut_trajs": extras[0],
            "gt_agent_fut_masks": extras[1],
            "gt_attr_labels": extras[2],
            "instance_inds": extras[3],
            "gt_map_labels": map_labels,
            "gt_map_pts": map_pts,
            "ego_status": data["ego_status"],
            "ego_status_mask": data["ego_status_mask"],
            "gt_ego_fut_cmd": data["gt_ego_fut_cmd"],
            "target_point": data["target_point"],
            "scene_token": data["scene_token"],
        }
        for k, v in data.items():
            if k.startswith("gt_ego_fut_") or k.startswith("gt_ego_spat_"):
                frame[k] = v
        return pp.pad_gt_frame(frame, self.max_gt_boxes, self.max_gt_map)
