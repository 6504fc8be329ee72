#!/usr/bin/env python3
"""``chip_smoke.py`` phase 16 alone (the dry run: every cell of
``repro_torch.launch.dryrun`` in subprocesses started before phase 1's
build, three runs on the card traced against their dry runs, the fused
matvec's table) on one NVIDIA card: the quick loop for work on the port's
dry run (``launch/dryrun.py``, ``roofline.py``, the kernels' meta twins).
The KRR data is phase 3's (``make_regression`` at the ``wlsh_krr``
config's n and d, from the seed).

    python3 tools/dry_run.py [--seed 0]

Run from the root of a checkout; the card's name and power limit are
printed.  Any failure exits non-zero, as the smoke run's."""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dry_run: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as C
    from repro_torch.configs.wlsh_krr import CONFIG
    from repro_torch.data import make_regression
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {C.card_line()}")
    t0 = time.perf_counter()
    with C.dryruns() as sweep:
        C.phase_build(torch)
        dev = torch.device("cuda", 0)
        x, y, _, _ = make_regression(CONFIG.n_points, 1, CONFIG.dim,
                                     rough=0.5, seed=args.seed)
        data = tuple(torch.from_numpy(a).to(dev) for a in (x, y))
        del x, y
        C.phase_dryrun(torch, dev, data, args.seed, sweep)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
