"""Frames completed over the whole window."""


def read(run):
    return run.units / run.window_s
