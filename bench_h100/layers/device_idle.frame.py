"""The device's idle share: 1 - device busy a unit in the profiled stretch
(merged operation intervals) / wall a unit in the unprofiled window, in %."""

from bench_h100.harness.readings import idle_percent


def read(run):
    return idle_percent(run)
