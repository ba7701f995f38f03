"""The sampler's forward share of its roofline, in %: the sum over the
profiled calls of ``ops.sampling.coarse_sample`` and ``patch_sample`` of
their least time (bytes their inputs make them read and their output, at
the HBM rate, or fp32 operations at the fp32 peak, whichever is larger)
over the device time of the operations launched inside those calls."""


def read(run):
    from bench_h100.harness.readings import roofline_percent

    return roofline_percent(run, "sampler_fwd")
