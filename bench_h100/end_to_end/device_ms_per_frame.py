"""The card's busy time a frame: the union of the device's operation
intervals (kernels, copies, fills) over the frames profiled after the
window, in ms a frame. It is the card time a frame costs, which sets how
many frames a second one card serves to the evaluation workers that share
it."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["units"]
