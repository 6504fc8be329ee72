#!/usr/bin/env python3
"""``chip_smoke.py`` phase 15 alone (the LM train step on grids of ranks:
gemma3-1b uncut on a 1x1 NCCL grid, then cut to 6 of its 26 layers on a
2x2 grid of four processes sharing the card over gloo, each against the
one-process train step on the card) on one NVIDIA card: the quick loop for work on the grid's training
path (``models/sharded.py``'s ``loss_fn``, ``launch/steps.py``).  No kernel
runs on this path, so nothing is built.

    python3 tools/mesh_training.py [--seed 0]

Run from the root of a checkout; the card's name and power limit are
printed with each part.  Any failure exits non-zero, as the smoke run's."""
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
        print("mesh_training: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {C.card_line()}")
    t0 = time.perf_counter()
    C.phase_train_mesh(torch, torch.device("cuda", 0), args.seed)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
