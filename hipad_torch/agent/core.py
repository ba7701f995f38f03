"""The closed-loop agent without a simulator (counterpart of
``hipad_tpu/agent/core.py``): ``AgentCore.run_step(obs)`` takes one
simulator tick's observation dict and returns one control dict; a CARLA
adapter and the replay harness (``agent/replay.py``) both feed it.

Each tick: the cameras go through a JPEG round trip at quality 20 (part of
the train/test distribution) and the native uint8 resize/crop
(``data/native.py``) on the host, travel to the card as uint8 and are
normalised there in fp32; the forward runs under ``torch.no_grad`` in fp32
or under bf16 autocast (the port's reading of the JAX package's ``dtype``);
then ``post_process_arrays`` decodes the plan and the PID controller turns
it into steer, throttle and brake with the JAX package's clipping.

The simulator runs at 20 Hz and the model was trained at 2 Hz, so the agent
holds ``n_banks`` (10) temporal bank states and uses them in round robin:
``bank_idx = step % n_banks``, so that each bank sees a 2 Hz stream.
"""

from __future__ import annotations

import io
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import postprocess
from ..configs.model import aug_conf_for
from ..data import native
from ..data import pipelines as pp
from ..models.common import to_float32
from ..models.detector import HiPAD
from .calib import CAMERAS, LIDAR2EGO, stacked_lidar2img
from .pid import PIDController

FRAME_RATE = 20  # Hz
CLOSE_LOOP_BANKS = 10  # 20 Hz sim / 2 Hz training


def jpeg_roundtrip(img_rgb: np.ndarray, quality: int = 20) -> np.ndarray:
    """Encode and decode at a low JPEG quality."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_rgb.astype(np.uint8)).save(buf, "JPEG", quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


def prepare_camera(img_rgb: np.ndarray, aug: Dict, jpeg_quality: Optional[int] = 20
                   ) -> np.ndarray:
    """One camera through the JPEG round trip and the training pipeline's
    PIL resize/crop (``pipelines.transform_image``), uint8 throughout."""
    if jpeg_quality is not None:
        img_rgb = jpeg_roundtrip(img_rgb, jpeg_quality)
    return np.ascontiguousarray(pp.transform_image(img_rgb, aug).astype(np.uint8))


def prepare_cameras(imgs_rgb: List[np.ndarray], aug: Dict, jpeg_quality: Optional[int] = 20
                    ) -> np.ndarray:
    """All cameras of one tick -> ``[cams, fH, fW, 3]`` uint8: the JPEG round
    trip per camera, then one native resize/crop pass over the stacked
    cameras. Cameras of different sizes cannot be stacked, and a rotated
    ``aug`` is not native: those take :func:`prepare_camera` per camera,
    as in the JAX package. (PIL's bilinear downscale filters over an area,
    the native pass takes 2 taps: the two differ, as
    ``tests/test_native_io.py`` bounds.)"""
    if jpeg_quality is not None:
        imgs_rgb = [jpeg_roundtrip(im, jpeg_quality) for im in imgs_rgb]
    if len({im.shape for im in imgs_rgb}) == 1 and not aug.get("rotate"):
        return native.resize_crop_cameras_u8(np.stack(imgs_rgb).astype(np.uint8, copy=False), aug)
    return np.stack([prepare_camera(im, aug, None) for im in imgs_rgb])


class AgentCore:
    """Stateful streaming inference and PID control.

    Args:
      cfg: model config (``stage2_serving_det`` is the one the repo serves).
      weights: a ``HiPAD`` state dict (``model.state_dict()``, or
        ``weights.from_jax`` of flax variables).
      dtype: ``torch.float32`` (or None) for an fp32 forward,
        ``torch.bfloat16`` for bf16 autocast.
      aug_conf: the cameras' augmentation, taken at test time; by default
        the stage-2 one at ``cfg.input_size`` (``configs.model.aug_conf_for``).
      device: where the model runs; the card unless the caller asks for the
        CPU.
    """

    def __init__(self, cfg, weights: Mapping[str, torch.Tensor], dtype=torch.bfloat16,
                 jpeg_quality: Optional[int] = 20, with_rescore: bool = True,
                 aug_conf: Optional[Dict] = None, n_banks: int = CLOSE_LOOP_BANKS,
                 visualize_dir: Optional[str] = None, visualize_interval: int = 20,
                 device="cuda"):
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = HiPAD(cfg, device=self.device)
        self.model.load_state_dict(weights)
        self.autocast = dtype == torch.bfloat16
        self.pid = PIDController(waypoint_time=0.2)
        self.banks: List = [None] * n_banks
        self.step = -1
        self.last_steer = 0.0
        self.jpeg_quality = jpeg_quality
        self.with_rescore = with_rescore
        self.metric_info: Dict[int, Dict] = {}
        self.visualize_dir = visualize_dir
        self.visualize_interval = visualize_interval

        self.aug_conf = aug_conf or aug_conf_for(cfg.input_size)
        self.aug = pp.sample_aug_config(self.aug_conf, test_mode=True)
        mat = pp.img_transform_matrix(self.aug)
        self.lidar2img = (mat[None] @ stacked_lidar2img()).astype(np.float32)
        h, w = self.aug_conf["final_dim"]
        self.image_wh = np.tile(np.array([w, h], np.float32), (len(CAMERAS), 1))
        self.mean = torch.as_tensor(pp.IMG_MEAN, device=self.device)
        self.std = torch.as_tensor(pp.IMG_STD, device=self.device)
        self.last_phase_ms: Dict[str, float] = {}

    def _forward(self, images_u8: torch.Tensor, metas: Dict[str, torch.Tensor], banks):
        """uint8 cameras -> (decoded plan/det/map arrays, new banks)."""
        with torch.no_grad():
            images = (images_u8.float() - self.mean) / self.std  # fp32, also under autocast
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.autocast):
                outputs, new_banks = self.model(images, metas, banks)
            decoded = postprocess.post_process_arrays(
                self.cfg, to_float32(outputs), metas["gt_ego_fut_cmd"], self.with_rescore)
        return decoded, new_banks

    # ---- observation -> metas ---------------------------------------------

    def _build_inputs(self, obs: Dict):
        pos = np.array([obs["pos"][0], -obs["pos"][1]])
        raw_theta = obs.get("compass", 0.0)
        if np.isnan(raw_theta):
            raw_theta = 0.0
        ego_theta = -raw_theta + np.pi / 2

        accel = np.asarray(obs.get("acceleration", np.zeros(3)))
        ang_vel = -np.asarray(obs.get("angular_velocity", np.zeros(3)))
        status = np.zeros(6, np.float32)
        status[0] = obs["speed"]
        status[1] = accel[0]
        status[2] = -accel[1]
        status[3:5] = ang_vel[:2]
        status[5] = self.last_steer

        cmd = int(obs.get("command", 4))
        if cmd < 0:
            cmd = 4
        cmd_onehot = np.zeros(6, np.float32)
        cmd_onehot[cmd - 1] = 1.0

        target_xy = np.array([obs["target_xy"][0], -obs["target_xy"][1]]) - pos
        rot = np.array([[np.cos(raw_theta), -np.sin(raw_theta)],
                        [np.sin(raw_theta), np.cos(raw_theta)]])
        target_point = (rot @ target_xy).astype(np.float32)

        ego2world = np.eye(4)
        c, s = np.cos(ego_theta), np.sin(ego_theta)
        ego2world[:2, :2] = [[c, -s], [s, c]]
        ego2world[0:2, 3] = pos
        lidar2global = (ego2world @ LIDAR2EGO).astype(np.float32)

        imgs = prepare_cameras([obs["images"][cam] for cam in CAMERAS], self.aug,
                               self.jpeg_quality)  # [cams, fH, fW, 3] uint8 RGB

        metas = {
            "timestamp": np.full((1,), self.step / FRAME_RATE, np.float32),
            "projection_mat": self.lidar2img[None],
            "image_wh": self.image_wh[None],
            "T_global": lidar2global[None],
            "T_global_inv": np.linalg.inv(lidar2global)[None].astype(np.float32),
            "target_point": target_point[None],
            "gt_ego_fut_cmd": cmd_onehot[None],
        }
        return imgs[None], metas, target_point

    # ---- one simulator tick ------------------------------------------------

    def run_step(self, obs: Dict) -> Dict:
        """obs: {"images": {cam: HxWx3 RGB uint8}, "pos": [x, y] (CARLA),
        "speed": m/s, "compass": rad, "acceleration": [3],
        "angular_velocity": [3], "target_xy": [2] (CARLA world),
        "command": int} -> {"steer", "throttle", "brake", "metadata"}."""
        self.step += 1
        t0 = time.perf_counter()
        images, metas, target_point = self._build_inputs(obs)
        t1 = time.perf_counter()
        images = torch.from_numpy(images).to(self.device)
        metas = {k: torch.from_numpy(v).to(self.device) for k, v in metas.items()}

        bank_idx = self.step % len(self.banks)
        decoded, new_bank = self._forward(images, metas, self.banks[bank_idx])
        self.banks[bank_idx] = new_bank

        temp = decoded["plan_speed_5hz"][0].cpu().numpy().astype(np.float64)
        t2 = time.perf_counter()
        self.last_phase_ms = {"host_preproc": (t1 - t0) * 1e3,
                              "upload_infer": (t2 - t1) * 1e3}
        spat = decoded.get("plan_spat_2m", decoded["plan_speed_5hz"])[0]
        spat = spat.cpu().numpy().astype(np.float64)
        steer, throttle, brake, meta = self.pid.control_pid(
            temp, spat, float(obs["speed"]), target_point)
        if brake < 0.05:
            brake = 0.0
        if throttle > brake:
            brake = 0.0
        steer = float(np.clip(steer, -1, 1))
        throttle = float(np.clip(throttle, 0, 0.75))
        brake = float(np.clip(brake, 0, 1))
        self.last_steer = steer
        meta.update({"plan_temp": temp.tolist(), "plan_spat": spat.tolist(),
                     "command": int(obs.get("command", 4))})
        self.metric_info[self.step] = meta

        if self.visualize_dir and self.step % self.visualize_interval == 0:
            self._dump_composite(decoded, obs, target_point)
        return {"steer": steer, "throttle": throttle, "brake": brake, "metadata": meta}

    def _dump_composite(self, decoded, obs, target_point):
        """The multi-camera and BEV composite of every ``visualize_interval``-th
        tick, as the JAX package's agent dumps it: detections on every camera,
        the plan trajectories and the target point on the front cameras and
        on the BEV panel, saved as ``<visualize_dir>/<step:06d>.jpg``; without
        PIL the BEV panel alone, as ``bev_<step:06d>.npy``."""
        import os

        from ..utils.viz import render_composite, render_frame

        os.makedirs(self.visualize_dir, exist_ok=True)
        res = postprocess.to_result_dicts(decoded)[0]
        try:
            from PIL import Image
        except ImportError:
            np.save(os.path.join(self.visualize_dir, f"bev_{self.step:06d}.npy"),
                    render_frame(res))
            return
        in_h, in_w = self.cfg.input_size
        cams = {cam: np.asarray(Image.fromarray(obs["images"][cam].astype(np.uint8))
                                .resize((in_w, in_h))) for cam in CAMERAS}
        l2i = {cam: self.lidar2img[i] for i, cam in enumerate(CAMERAS)}
        img = render_composite(cams, l2i, res, target_point=target_point)
        Image.fromarray(img).save(os.path.join(self.visualize_dir, f"{self.step:06d}.jpg"),
                                  quality=85)
