"""Model FLOPs a frame (``model_flops_per_frame`` of the configuration's
file, counted over the plain reference) x units over the unprofiled window,
as a share of the card's dense bf16 peak, in %."""

from bench_h100.harness.readings import mfu_percent


def read(run):
    return mfu_percent(run)
