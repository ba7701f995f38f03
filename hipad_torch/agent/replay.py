"""Fake closed-loop driver (CARLA mock).

The reference's only no-simulator testing device is scenario_runner's
``carla_mocks`` (SURVEY §4.3). Here: a kinematic toy world that feeds the
agent synthetic camera frames + route targets at 20 Hz, integrates the
returned control with a bicycle model, and reports route progress — enough to
exercise the full agent stack (preprocessing, streaming banks, plan decode,
PID) without CARLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .calib import CAMERAS, IMG_H, IMG_W
from .core import FRAME_RATE, AgentCore


class FakeSim:
    """Straight-road kinematic world in CARLA conventions."""

    def __init__(self, route_length: float = 100.0, seed: int = 0,
                 img_hw=(IMG_H, IMG_W)):
        self.rng = np.random.RandomState(seed)
        self.route_length = route_length
        self.img_hw = img_hw
        self.pos = np.zeros(2)  # CARLA frame (y right)
        self.yaw = 0.0  # CARLA compass=0 -> facing +x? compass handled below
        self.speed = 0.0
        self.t = 0

    def observe(self) -> Dict:
        h, w = self.img_hw
        images = {
            cam: self.rng.randint(0, 255, (h, w, 3), np.uint8)
            for cam in CAMERAS
        }
        target = np.array([min(self.pos[0] + 20.0, self.route_length), 0.0])
        return {
            "images": images,
            "pos": self.pos.copy(),
            "speed": self.speed,
            "compass": np.pi / 2,  # facing +x in CARLA compass terms
            "acceleration": np.zeros(3),
            "angular_velocity": np.zeros(3),
            "target_xy": target,
            "command": 4,  # LANE FOLLOW
        }

    def apply(self, control: Dict):
        dt = 1.0 / FRAME_RATE
        accel = 3.0 * control["throttle"] - 8.0 * control["brake"] - 0.1
        self.speed = float(np.clip(self.speed + accel * dt, 0.0, 20.0))
        self.yaw += control["steer"] * self.speed * dt * 0.2
        self.pos += self.speed * dt * np.array([np.cos(self.yaw), np.sin(self.yaw)])
        self.t += 1

    @property
    def done(self) -> bool:
        return self.pos[0] >= self.route_length


def scripted_route(straight: float = 40.0, turn_radius: float = 20.0,
                   turn_deg: float = 90.0, exit_straight: float = 40.0,
                   spacing: float = 2.0):
    """Waypoint polyline in the CARLA frame: straight along +x, a left turn
    (CARLA left = -y), then straight along the exit heading. Each waypoint
    carries a leaderboard command: 4 (LANEFOLLOW) on the straights, 1 (LEFT)
    through the arc — the command layout the leaderboard's route
    interpolation produces around a junction."""
    pts, cmds = [], []
    for i in range(int(straight / spacing)):
        pts.append((i * spacing, 0.0))
        cmds.append(4)
    ang = np.radians(turn_deg)
    n_arc = max(2, int(ang * turn_radius / spacing))
    for i in range(1, n_arc + 1):
        a = ang * i / n_arc
        pts.append((straight + turn_radius * np.sin(a),
                    -turn_radius * (1.0 - np.cos(a))))
        cmds.append(1)
    hx, hy = np.cos(ang), -np.sin(ang)
    ex, ey = pts[-1]
    for i in range(1, int(exit_straight / spacing) + 1):
        pts.append((ex + hx * i * spacing, ey + hy * i * spacing))
        cmds.append(4)
    return [(np.array(p, np.float64), c) for p, c in zip(pts, cmds)]


def run_scripted_replay(agent: AgentCore, route, n_ticks: int,
                        speed: float = 5.0, seed: int = 0,
                        img_hw=(IMG_H, IMG_W), on_tick=None,
                        images_fn=None):
    """Drive the ego ALONG the scripted route at constant speed (the motion
    is scripted, not closed over the agent's control — decoupling pipeline
    mechanics from model quality) while the agent observes every tick
    through a ``RoutePlanner`` fed exactly like the reference agent's
    (`hipad_b2d_agent.py:359-393`: RoutePlanner(4, 50), target = route[1][0],
    command = route[0][1]). Returns the per-tick log with the control dict,
    the live command, and the planner's remaining route length."""
    from .planner import RoutePlanner

    planner = RoutePlanner(min_distance=4.0, max_distance=50.0)
    planner.route.extend((p.copy(), c) for p, c in route)

    # arc-length parameterisation of the scripted polyline
    pts = np.stack([p for p, _ in route])
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    rng = np.random.RandomState(seed)
    h, w = img_hw
    dt = 1.0 / FRAME_RATE

    log: List[Dict] = []
    for t in range(n_ticks):
        s = min(speed * t * dt, cum[-1] - 1e-6)
        i = int(np.searchsorted(cum, s, side="right") - 1)
        i = min(i, len(seg) - 1)
        frac = (s - cum[i]) / max(seg[i], 1e-9)
        pos = pts[i] * (1 - frac) + pts[i + 1] * frac
        tangent = (pts[i + 1] - pts[i]) / max(seg[i], 1e-9)
        yaw = float(np.arctan2(tangent[1], tangent[0]))  # CARLA frame

        remaining = planner.run_step(pos)
        target_xy = remaining[1][0] if len(remaining) >= 2 else remaining[0][0]
        command = remaining[0][1]

        # frame production is the simulator's job; latency-measurement
        # harnesses pass images_fn to serve pre-rendered frames so the
        # ~26 MP/tick random render doesn't masquerade as agent cost
        obs = {
            "images": (images_fn(t) if images_fn is not None else
                       {cam: rng.randint(0, 255, (h, w, 3), np.uint8)
                        for cam in CAMERAS}),
            "pos": pos.copy(),
            "speed": speed,
            "compass": np.pi / 2 + yaw,  # CARLA compass: pi/2 faces +x
            "acceleration": np.zeros(3),
            "angular_velocity": np.zeros(3),
            "target_xy": np.asarray(target_xy, np.float64),
            "command": int(command),
        }
        control = agent.run_step(obs)
        log.append({**control, "pos": pos.copy(), "command": int(command),
                    "route_len": len(remaining)})
        if on_tick is not None:
            on_tick(t, agent)
    return log


def run_replay(agent: AgentCore, max_steps: int = 40, sim: Optional[FakeSim] = None):
    """Run the agent against the fake sim; returns per-step control log."""
    sim = sim or FakeSim()
    log: List[Dict] = []
    for _ in range(max_steps):
        control = agent.run_step(sim.observe())
        sim.apply(control)
        log.append({**control, "pos": sim.pos.copy(), "speed": sim.speed})
        if sim.done:
            break
    return log
