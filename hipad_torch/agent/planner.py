"""GPS route planner for the closed-loop agent.

Behavioral port of the Bench2Drive leaderboard team-code planner
(`bench2drive/leaderboard/team_code/planner.py:41-122`): holds the global
route as a queue of (xy, command) entries, converts GNSS fixes to CARLA
world coordinates with a Mercator projection referenced at (lat_ref,
lon_ref), and on each tick pops every waypoint already passed — the
farthest route point within ``min_distance`` of the ego, scanning only the
leading ``max_distance`` metres of route — always keeping >= 2 entries so
the consumer can read a current command and a next target.

Also provides ``solve_latlon_ref`` (`hipad_b2d_agent.py:330-356`): CARLA
towns place the GNSS origin at town-specific (lat_ref, lon_ref); the agent
recovers them from one (lon, lat) <-> (x, y) correspondence of the first
route point by solving the inverse Mercator equations.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Iterable, List, Sequence, Tuple

import numpy as np

EARTH_RADIUS_EQUA = 6378137.0  # WGS-84 equatorial radius (planner.py:6)


def gps_to_location(gps: Sequence[float], lat_ref: float, lon_ref: float) -> np.ndarray:
    """[lat, lon] -> CARLA world [x, y] (Mercator about the town origin).

    Matches `planner.py:108-115` / `hipad_b2d_agent.py:444-453` exactly,
    including the y-axis flip (CARLA's y grows south).
    """
    lat, lon = float(gps[0]), float(gps[1])
    scale = math.cos(lat_ref * math.pi / 180.0)
    my = math.log(math.tan((lat + 90.0) * math.pi / 360.0)) * (EARTH_RADIUS_EQUA * scale)
    mx = (lon * (math.pi * EARTH_RADIUS_EQUA * scale)) / 180.0
    y = scale * EARTH_RADIUS_EQUA * math.log(
        math.tan((90.0 + lat_ref) * math.pi / 360.0)) - my
    x = mx - scale * lon_ref * math.pi * EARTH_RADIUS_EQUA / 180.0
    return np.array([x, y])


def solve_latlon_ref(lon: float, lat: float, locx: float, locy: float,
                     ) -> Tuple[float, float]:
    """Recover the town's (lat_ref, lon_ref) from one GNSS<->world pair.

    Solves the same two inverse-Mercator equations the reference feeds to
    scipy.fsolve (`hipad_b2d_agent.py:337-356`); falls back to (0, 0) on
    failure like the reference's except-branch.
    """
    try:
        from scipy.optimize import fsolve

        def equations(vars):
            x, yv = vars
            eq1 = ((lon * math.cos(x * math.pi / 180) - (locx * x * 180)
                    / (math.pi * EARTH_RADIUS_EQUA))
                   - math.cos(x * math.pi / 180) * yv)
            eq2 = (math.log(math.tan((lat + 90) * math.pi / 360))
                   * EARTH_RADIUS_EQUA * math.cos(x * math.pi / 180) + locy
                   - math.cos(x * math.pi / 180) * EARTH_RADIUS_EQUA
                   * math.log(math.tan((90 + x) * math.pi / 360)))
            return [eq1, eq2]

        sol = fsolve(equations, [0.0, 0.0])
        return float(sol[0]), float(sol[1])
    except Exception:
        return 0.0, 0.0


class RoutePlanner:
    """Windowed route-following queue (`planner.py:41-106`).

    Args:
      min_distance: a route point closer than this to the ego counts as
        reached (the farthest such point pops everything before it).
      max_distance: how far along the route (cumulative metres) to scan for
        reached points each tick.
    """

    def __init__(self, min_distance: float, max_distance: float,
                 lat_ref: float = 42.0, lon_ref: float = 2.0):
        self.route: deque = deque()
        self.min_distance = float(min_distance)
        self.max_distance = float(max_distance)
        self.lat_ref = float(lat_ref)
        self.lon_ref = float(lon_ref)

    def set_route(self, global_plan: Iterable, gps: bool = False) -> None:
        """Load a leaderboard global plan: [(pos, command), ...] where pos is
        either a {'lat','lon'} dict (gps=True) or a carla Transform."""
        self.route.clear()
        for pos, cmd in global_plan:
            if gps:
                pos = gps_to_location(
                    (pos["lat"], pos["lon"]), self.lat_ref, self.lon_ref)
            else:
                pos = np.array([pos.location.x, pos.location.y])
            self.route.append((pos, cmd))

    def gps_to_location(self, gps: Sequence[float]) -> np.ndarray:
        return gps_to_location(gps, self.lat_ref, self.lon_ref)

    def run_step(self, pos: np.ndarray) -> List:
        """Pop passed waypoints; return the remaining route (a sequence whose
        [0] is the live segment: consumers read [0][1] as the current command
        and [1][0] as the target point)."""
        if len(self.route) == 1:
            return [self.route[0]]

        to_pop = 0
        farthest_in_range = -np.inf
        cumulative_distance = 0.0
        for i in range(1, len(self.route)):
            if cumulative_distance > self.max_distance:
                break
            cumulative_distance += float(
                np.linalg.norm(self.route[i][0] - self.route[i - 1][0]))
            distance = float(np.linalg.norm(self.route[i][0] - pos))
            # NOTE: `distance > farthest_in_range` (not <) is the reference's
            # own comparison (`planner.py:97-99`): among in-range points it
            # tracks the one *farthest* from the ego, popping maximally.
            if distance <= self.min_distance and distance > farthest_in_range:
                farthest_in_range = distance
                to_pop = i

        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()

        return list(self.route)
