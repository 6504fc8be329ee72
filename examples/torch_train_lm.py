"""End-to-end LM training with fault injection on the PyTorch port: trains
a reduced gemma3 on the synthetic token stream for a few hundred steps,
killing the process state twice along the way — the run auto-resumes from
checkpoints and still converges.  (On a card with room for it, drop
--smoke from ``CMD`` to train the full config.)

    PYTHONPATH=src python examples/torch_train_lm.py [--device cuda|cpu]
        [--ckpt-dir DIR] [--steps N --ckpt-every N --fail-at S1 S2]

The launcher is ``python -m repro_torch.launch.train`` with the JAX example's
flags.  The child keeps the caller's environment (the card's variables)
with ``src`` on the path, and checkpoints into a fresh temporary directory
unless ``--ckpt-dir`` is given, so a second run trains again rather than
resuming at its last step.  ``--steps``, ``--ckpt-every`` and ``--fail-at``
pass a shorter schedule to the launcher.  Exits with the launcher's code: 0
when the mean of its last 10 losses is below that of its first 10.
"""
import argparse
import os
import subprocess
import sys
import tempfile

from repro_torch.backend import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, CKPT_EVERY, FAIL_AT = 200, 25, (60, 130)


def command(device: str, ckpt_dir: str, *, steps: int = STEPS,
            ckpt_every: int = CKPT_EVERY, fail_at=FAIL_AT) -> list[str]:
    return [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "gemma3-1b", "--smoke",
        "--steps", str(steps), "--batch", "8", "--seq", "128",
        "--lr", "3e-3", "--ckpt-dir", ckpt_dir,
        "--ckpt-every", str(ckpt_every),
        "--fail-at", *(str(s) for s in fail_at),
        "--device", device,
    ]


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
                    help="cuda: the card (raises without one); cpu: the "
                         "plain PyTorch path")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed after the run)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--ckpt-every", type=int, default=CKPT_EVERY)
    ap.add_argument("--fail-at", type=int, nargs="*", default=FAIL_AT)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    sched = dict(steps=args.steps, ckpt_every=args.ckpt_every,
                 fail_at=args.fail_at)
    if args.ckpt_dir:
        return run(command(args.device, args.ckpt_dir, **sched))
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as d:
        return run(command(args.device, d, **sched))


if __name__ == "__main__":
    raise SystemExit(main())
