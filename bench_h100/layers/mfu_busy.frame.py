"""Model FLOPs a frame (``model_flops_per_frame`` of the configuration's
file) over the card's busy time a frame in the profiled stretch, as a share
of the card's dense bf16 peak, in %: the whole frame's share of the peak
while the card works."""

from bench_h100.counts.peaks import BF16_FLOP_PER_S


def read(run):
    flops, t = run.cell.config.get("model_flops_per_frame"), run.trace
    if not flops or t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * flops * t["units"] / t["busy_s"] / BF16_FLOP_PER_S
