"""The CARLA leaderboard agent around ``AgentCore`` (counterpart of
``hipad_tpu/agent/carla_adapter.py``): the leaderboard loads this file with
``--agent``, calls ``get_entry_point()`` for the class name, then ``setup``,
``sensors`` and ``run_step`` once a simulator tick. Importable without the
``leaderboard`` and ``carla`` packages (the Bench2Drive evaluation machines
have them): a stub stands in for ``AutonomousAgent``, and ``run_step``
returns a plain control dict where ``carla.VehicleControl`` does not exist.

Config string (the leaderboard's ``--agent-config``):
``"<ckpt_dir>+<save_name>[+config=<factory>]"``. ``ckpt_dir`` is a work
dir of the port's checkpoints (``python -m hipad_torch.tools.train``, or
``python -m hipad_torch.tools.convert_weights`` for a released ``.pth``);
without one the weights are the port's seeded initialisation.
``config=`` names a config factory of ``hipad_torch.configs.model``
(default ``stage2``). The model runs on the card.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from .calib import CAMERAS
from .core import AgentCore
from .planner import RoutePlanner, solve_latlon_ref

SEED = 0  # the seeded initialisation when no checkpoint is given


def get_entry_point():
    return "HiPADTorchAgent"


def _sensor_specs():
    """Six cameras, IMU, GNSS and the speedometer, as the JAX package's
    adapter (and the reference agent) mounts them."""
    from .calib import CAMERA_RIG, IMG_H, IMG_W

    sensors = []
    for cam, (x, y, z, yaw, fov) in CAMERA_RIG.items():
        sensors.append({
            "type": "sensor.camera.rgb", "x": x, "y": y, "z": z,
            "roll": 0.0, "pitch": 0.0, "yaw": yaw,
            "width": IMG_W, "height": IMG_H, "fov": fov, "id": cam,
        })
    sensors += [
        {"type": "sensor.other.imu", "x": -1.4, "y": 0.0, "z": 0.0,
         "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.05, "id": "IMU"},
        {"type": "sensor.other.gnss", "x": -1.4, "y": 0.0, "z": 0.0,
         "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.01, "id": "GPS"},
        {"type": "sensor.speedometer", "reading_frequency": 20, "id": "SPEED"},
    ]
    return sensors


try:
    import carla  # noqa: F401
    from leaderboard.autoagents import autonomous_agent

    _HAVE_CARLA = True
except ImportError:
    _HAVE_CARLA = False

    class autonomous_agent:  # type: ignore
        class AutonomousAgent:
            def __init__(self, *a, **k):
                pass

        class Track:
            SENSORS = "SENSORS"


class HiPADTorchAgent(autonomous_agent.AutonomousAgent):
    def _make_config(self, name: str):
        """Resolve a named config factory; overridable by test harnesses."""
        from ..configs import model as config_registry

        factory = getattr(config_registry, name, None)
        if not callable(factory):
            raise ValueError(f"unknown config factory {name!r}")
        return factory()

    def _agent_core_kwargs(self) -> dict:
        """Extra ``AgentCore`` kwargs; overridable by test harnesses."""
        return {}

    def _initial_weights(self, cfg) -> dict:
        """The state dict before a checkpoint loads over it: the port's
        seeded initialisation, drawn on the CPU so that it is the same on
        every device; overridable by test harnesses."""
        from ..models.detector import HiPAD
        from ..weights import init_random

        return init_random(HiPAD(cfg, device="cpu"), SEED).state_dict()

    def setup(self, path_to_conf_file):
        from ..train import checkpoint

        self.track = autonomous_agent.Track.SENSORS
        parts = (path_to_conf_file or "").split("+")
        ckpt_dir = parts[0]
        opts = dict(p.split("=", 1) for p in parts[1:] if "=" in p)
        unknown = sorted(set(opts) - {"config"})
        if unknown:
            # a mistyped key ("+confg=tiny") would otherwise run the stage2
            # default without a word
            raise ValueError(
                f"unknown agent conf option(s) {unknown}; supported: ['config']")
        names = [p for p in parts[1:] if p and "=" not in p]
        self.save_name = names[-1] if names else "hipad_torch"

        cfg = self._make_config(opts.get("config", "stage2"))
        self.core = AgentCore(cfg, self._initial_weights(cfg), **self._agent_core_kwargs())
        if ckpt_dir and os.path.isdir(ckpt_dir):
            checkpoint.load_params_only(ckpt_dir, self.core.model)
        self._route_planner = None
        self.save_path = Path(os.environ.get("SAVE_PATH", ".")) / self.save_name
        self.save_path.mkdir(parents=True, exist_ok=True)
        self.lat_ref, self.lon_ref = 42.0, 2.0

    def sensors(self):
        return _sensor_specs()

    def gps_to_location(self, gps):
        """GNSS [lat, lon] -> CARLA world [x, y]."""
        from .planner import gps_to_location

        return gps_to_location(gps, self.lat_ref, self.lon_ref)

    def _init_planner(self):
        # the town's GNSS origin from the first route point's gps<->world
        # pair; the (42, 2) default where only the gps-frame plan exists
        try:
            wp0 = self._global_plan_world_coord[0][0]
            p0 = self._global_plan[0][0]
            self.lat_ref, self.lon_ref = solve_latlon_ref(
                p0["lon"], p0["lat"], wp0.location.x, wp0.location.y)
        except Exception:
            pass
        self._route_planner = RoutePlanner(
            4.0, 50.0, lat_ref=self.lat_ref, lon_ref=self.lon_ref)
        self._route_planner.set_route(self._global_plan, True)

    def run_step(self, input_data, timestamp):
        if self._route_planner is None:
            self._init_planner()

        gps = input_data["GPS"][1][:2]
        pos = self.gps_to_location(gps)
        routes = self._route_planner.run_step(pos)
        if len(routes) >= 2:
            target_xy, command = routes[1][0], routes[0][1]
        else:
            target_xy, command = routes[0][0], routes[0][1]

        obs = {
            "images": {cam: input_data[cam][1][:, :, :3][..., ::-1]  # BGRA->RGB
                       for cam in CAMERAS},
            "pos": pos,
            "speed": input_data["SPEED"][1]["speed"],
            "compass": input_data["IMU"][1][-1],
            "acceleration": np.asarray(input_data["IMU"][1][:3]),
            "angular_velocity": np.asarray(input_data["IMU"][1][3:6]),
            "target_xy": np.asarray(target_xy),
            "command": int(command),
        }
        out = self.core.run_step(obs)

        with open(self.save_path / "metric_info.json", "w") as f:
            json.dump(self.core.metric_info, f, indent=2, default=float)

        if _HAVE_CARLA:
            control = carla.VehicleControl()
            control.steer = out["steer"]
            control.throttle = out["throttle"]
            control.brake = out["brake"]
            return control
        return out

    def destroy(self):
        self.core = None
