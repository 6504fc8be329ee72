#!/usr/bin/env python3
"""The port's benchmark: run one cell of ``BENCHMARK.json`` once.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout.  It drives ``repro_torch`` (under
``src/``) on the card, prints the numbers the reference compared beside
their limits as the last lines of standard error, and one JSON result as
the last line of standard output.  Without enough CUDA devices it exits
non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import sys                      # noqa: E402
from pathlib import Path        # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from port_bench.harness import main   # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
