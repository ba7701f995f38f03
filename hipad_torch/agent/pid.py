"""Waypoint-following PID controller.

Behavioural port of `bench2drive/leaderboard/team_code/pid_controller.py:
5-154` with the agent's closed-loop gains (`hipad_b2d_agent.py:256-265`):
turn PID steers toward the spatial waypoint whose segment-midpoint norm best
matches the current speed; the speed PID tracks the mean step distance of the
temporal trajectory divided by ``waypoint_time``; brake when desired speed is
tiny or current speed overshoots it by >10%.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np


class PID:
    def __init__(self, k_p=1.0, k_i=0.0, k_d=0.0, n=20):
        self.k_p, self.k_i, self.k_d = k_p, k_i, k_d
        self.window = deque([0.0] * n, maxlen=n)

    def step(self, error: float) -> float:
        self.window.append(error)
        integral = float(np.mean(self.window))
        derivative = self.window[-1] - self.window[-2]
        return self.k_p * error + self.k_i * integral + self.k_d * derivative


class PIDController:
    """Closed-loop gains from `hipad_b2d_agent.py:256-265`."""

    def __init__(
        self,
        turn_kp=1.0, turn_ki=0.75, turn_kd=0.0, turn_n=10,
        speed_kp=5.0, speed_ki=0.5, speed_kd=1.0, speed_n=10,
        max_throttle=0.75, brake_speed=0.4, brake_ratio=1.1,
        clip_delta=0.25, waypoint_time=0.2,
    ):
        self.turn = PID(turn_kp, turn_ki, turn_kd, turn_n)
        self.speed = PID(speed_kp, speed_ki, speed_kd, speed_n)
        self.max_throttle = max_throttle
        self.brake_speed = brake_speed
        self.brake_ratio = brake_ratio
        self.clip_delta = clip_delta
        self.waypoint_time = waypoint_time

    def control_pid(
        self,
        waypoints: np.ndarray,
        spatial_waypoints: Optional[np.ndarray],
        speed: float,
        target: np.ndarray,
    ) -> Tuple[float, float, float, Dict]:
        """Args:
          waypoints: [T, 2] temporal trajectory (cumulative, ego frame) — sets
            the desired speed.
          spatial_waypoints: [K, 2] or None — sets the steering aim point; the
            temporal trajectory is used when absent.
          speed: current speed m/s; target: [2] route target point.
        Returns (steer, throttle, brake, metadata).
        """
        pts = spatial_waypoints if spatial_waypoints is not None else waypoints
        num_pairs = len(waypoints) - 1
        desired_speed = float(
            sum(np.linalg.norm(waypoints[i + 1] - waypoints[i]) / self.waypoint_time
                for i in range(num_pairs)) / max(num_pairs, 1)
        )

        # aim = the waypoint whose *segment midpoint* distance best matches
        # the current speed (aim_dist = speed, `pid_controller.py:86,92-107`).
        aim_dist = speed
        aim = pts[0]
        best = 1e5
        for i in range(len(pts) - 1):
            norm = float(np.linalg.norm((pts[i + 1] + pts[i]) / 2.0))
            if abs(aim_dist - best) > abs(aim_dist - norm):
                aim = pts[i]
                best = norm

        angle = float(np.degrees(np.pi / 2 - np.arctan2(aim[1], aim[0])) / 90.0)
        steer = float(np.clip(self.turn.step(angle), -1.0, 1.0))

        brake = desired_speed < self.brake_speed or (
            desired_speed > 0 and speed / desired_speed > self.brake_ratio
        )
        delta = float(np.clip(desired_speed - speed, 0.0, self.clip_delta))
        throttle = float(np.clip(self.speed.step(delta), 0.0, self.max_throttle))
        throttle = 0.0 if brake else throttle

        meta = {
            "speed": float(speed), "steer": steer, "throttle": throttle,
            "brake": float(brake), "aim": tuple(np.asarray(aim, np.float64)),
            "target": tuple(np.asarray(target, np.float64)),
            "desired_speed": desired_speed, "angle": angle, "delta": delta,
        }
        return steer, throttle, float(brake), meta
