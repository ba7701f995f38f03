"""From process start to the first timed unit: imports, builds, inputs,
weights, the program's construction and the warm-up units."""


def read(run):
    return run.setup_s
