"""The harness: cells from ``BENCHMARK.json``, traffic from data files, the
timed window, the traced stretches, and the comparison with the plain
reference."""
