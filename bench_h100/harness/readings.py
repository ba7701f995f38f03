"""Arithmetic that several metric readers share."""

from __future__ import annotations

from typing import Optional

from ..counts.peaks import BF16_FLOP_PER_S


def idle_percent(run) -> Optional[float]:
    """``1 - device busy a unit (profiled) / wall a unit (unprofiled)``, in %."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    busy = run.trace["busy_s"] / run.trace["units"]
    return 100.0 * (1.0 - busy / (run.window_s / run.units))


def mfu_percent(run) -> Optional[float]:
    """Model FLOPs of the configuration's frame x units over the unprofiled
    window, as a share of the card's dense bf16 peak, in %."""
    flops = run.cell.config.get("model_flops_per_frame")
    if not flops:
        return None
    return 100.0 * flops * run.units / run.window_s / BF16_FLOP_PER_S


def roofline_percent(run, key: str) -> Optional[float]:
    """The least time of the calls under the ranges ``key`` names over the
    device time of the operations launched inside them, in %."""
    t = run.trace
    if t is None or not t.get("sampler_calls") or t["device_s"][key] <= 0:
        return None
    return 100.0 * t["least_s"][key] / t["device_s"][key]
