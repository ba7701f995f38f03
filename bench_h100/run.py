"""Run one cell of the benchmark once, on the machine it is started on:

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json``; what each cell is
made of is found by name under this directory. The last line of standard
output is the result's JSON object; the last lines of standard error give
each number of the correctness check beside its limit.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_h100" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_h100" / "triton")

if __name__ == "__main__":
    from bench_h100.harness.runner import main

    sys.exit(main(t_start=T_START))
