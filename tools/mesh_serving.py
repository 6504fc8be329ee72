#!/usr/bin/env python3
"""``chip_smoke.py`` phase 13 alone (the dense LMs served on grids of
ranks), with the kernels' build and phase 2's B9 parity before it and B9
timed at each local shape the grids launched it at after it, on one NVIDIA
card: the quick loop for work on ``models/sharded.py``.

    python3 tools/mesh_serving.py [--seed 0]

Run from the root of a checkout; the card's name and power limit are
printed with the phase.  Any failure exits non-zero, as the smoke run's."""
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
        print("mesh_serving: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.MAIN.update(C.krr_sizes(torch))
    t0 = time.perf_counter()
    C.phase_build(torch)
    dev = torch.device("cuda", 0)
    C.phase_parity_decode(torch, dev, args.seed)
    counts, shapes = C.phase_mesh(torch, dev, args.seed)
    C.decode_serve_times(torch, dev, args.seed, shapes, label="phase 13")
    print(f"done in {time.perf_counter() - t0:.1f} s; B9 launches "
          f"{counts['flash_decode']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
