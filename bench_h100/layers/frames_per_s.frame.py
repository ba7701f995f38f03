"""Frames completed over the whole unprofiled window, on the host clock:
the frame rate, which the host sets while the frame is host-bound."""


def read(run):
    return run.units / run.window_s
