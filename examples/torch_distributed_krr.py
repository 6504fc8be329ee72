"""The paper's workload, distributed, on the PyTorch port: WLSH-KRR on a
grid of ``torch.distributed`` ranks, exercising the all-reduced bucket
tables and sharded CG that the dry run (``repro_torch.launch.dryrun``)
traces for 512 cards.

    PYTHONPATH=src python examples/torch_distributed_krr.py [--device cuda|cpu]

``--device cpu`` runs 8 gloo ranks, one process each, through
``torch.distributed.run --standalone`` (the counterpart of the JAX
example's 8 forced CPU devices).  ``--device cuda`` (the default) runs one
rank on the card over NCCL, which takes one rank a device; without a card
it raises.  The launcher is ``python -m repro_torch.launch.krr_train`` with
the JAX example's flags.
"""
import argparse
import os
import subprocess
import sys

from repro_torch.backend import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = [sys.executable, "-m", "repro_torch.launch.krr_train",
       "--dataset", "forest", "--scale", "0.002", "--m", "64",
       "--lam", "0.5", "--cg-iters", "40"]
CPU_RANKS = 8


def command(device: str, ranks: int = CPU_RANKS) -> list[str]:
    """The launcher's command line: one process on the card, or ``ranks``
    gloo processes on the CPU."""
    if device == "cuda":
        return CMD + ["--device", "cuda"]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(ranks), *CMD[1:], "--device", "cpu"]


def child_env() -> dict:
    """The caller's environment (the card's variables kept) with the
    repository's ``src`` on the path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in ("src", env.get("PYTHONPATH")) if p)
    return env


def run(cmd: list[str]) -> int:
    """Run ``cmd`` from the repository's root; its exit code."""
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, env=child_env(), cwd=ROOT).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: one rank on the card (raises without a "
                         "card); cpu: 8 gloo ranks")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return run(command(args.device))


if __name__ == "__main__":
    raise SystemExit(main())
