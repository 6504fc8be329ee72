#!/usr/bin/env python3
"""``chip_smoke.py`` phases 13 and 14 alone (the LMs served on grids of
ranks: the dense archs, then the other slot kinds), with the kernels'
build and phase 2's B9 parity before them and B9 timed at each local shape
the grids launched it at after them, on one NVIDIA card: the quick loop for
work on ``models/sharded.py``.

    python3 tools/mesh_serving.py [--seed 0] [--phases 13 14]
    python3 tools/mesh_serving.py --phases 14 --slot-grids c=1x1 c=1x2 c=1x4

``--slot-grids`` runs phase 14's models (``SLOT_GRIDS``, by label) on the
grids given instead of their own.  Run from the root of a checkout; the
card's name and power limit are printed with each phase.  Any failure
exits non-zero, as the smoke run's."""
from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", type=int, nargs="+", default=[13, 14],
                    choices=[13, 14])
    ap.add_argument("--slot-grids", nargs="+", metavar="LABEL=DxM",
                    help="phase 14's model LABEL on a D x M grid")
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
    grids = None
    if args.slot_grids:
        grids = {}
        for item in args.slot_grids:
            label, shape = item.split("=")
            d, m = (int(v) for v in shape.split("x"))
            grids[label + shape] = dict(C.SLOT_GRIDS[label], grid=(d, m))
    runs = {13: C.phase_mesh,
            14: functools.partial(C.phase_slot_grids, grids=grids)}
    for phase in args.phases:
        counts, shapes = runs[phase](torch, dev, args.seed)
        C.decode_serve_times(torch, dev, args.seed, shapes,
                             label=f"phase {phase}")
        print(f"phase {phase}: B9 launches {counts['flash_decode']}")
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
