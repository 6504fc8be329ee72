#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers the
reference compares, for the program (``--program port``) or for the
control (``--program control``: the reference in bfloat16 in its place),
on many seeds in one process, each with a short window at the cell's own
sizes.

    python3 port_bench/readings.py --workload fit.wlsh_krr \\
        --program control --seeds 11 12 13 --seconds 2

Prints one JSON line a seed (its checks and ``correct``).  Needs the card,
like ``run.py``; the benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch                                  # noqa: E402

from port_bench import harness                # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("port", "control"),
                    default="port")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--checked-every", type=int, default=0,
                    help="judge every k-th predict call (the control's "
                    "calls are slower; 0: the mix's own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    over = ({"checked_every": args.checked_every} if args.checked_every
            else None)
    for seed in args.seeds:
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, program=args.program,
                               traffic_override=over)
        print(json.dumps(harness._finite({
            "workload": args.workload, "program": args.program,
            "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"]})),
            flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
