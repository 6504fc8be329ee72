#!/usr/bin/env python3
"""``chip_smoke.py`` phase 17 alone (the port's five examples,
``examples/torch_*.py``, on the card: three in this process through their
``main(argv)`` with the kernels' launches counted, two as a user runs them
in processes of their own) after phase 1's build, on one NVIDIA card: the
quick loop for work on the examples.

    python3 tools/examples_on_card.py

Run from the root of a checkout; torch_train_lm.py runs at the smoke
run's schedule (``chip_smoke.TRAIN_LM_ARGS``).  The card's name and power
limit are printed.  Any failure exits non-zero, as the smoke run's."""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print("examples_on_card: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {C.card_line()}")
    t0 = time.perf_counter()
    C.phase_build(torch)
    t1 = time.perf_counter()
    counts = C.phase_examples(torch)
    print(f"examples_launches {counts}")
    print(f"build {t1 - t0:.1f} s, phase 17 {time.perf_counter() - t1:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
