"""End-to-end LM trainer of the port: synthetic token batches ->
train step -> fault-tolerant loop with asynchronous checkpoints.  The port
of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --smoke --device cpu --steps 200 --batch 8 --seq 256

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; without a card that raises, there is no fallback).  ``--smoke``
uses the reduced same-family config; omit it on the card to train the full
config.  The loop resumes from the newest complete checkpoint under
``--ckpt-dir``, so rerunning the same command after a crash continues the
run; ``--fail-at`` injects failures to exercise that path.  Whisper's
encoder frames and the VLM's image patches are drawn per step from
(``--seed``, step) (``steps.source_inputs``), so a replayed step sees the
same batch.  Exits 0 when the
mean of the last 10 losses is below the mean of the first 10, else 2.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..backend import resolve_device
from ..configs import registry
from ..data import synthetic_lm_batch
from ..data.tokens import step_generator
from ..models import model
from ..optim import AdamWConfig
from ..runtime import FailureInjector, RestartableLoop, StragglerWatchdog
from .steps import init_train_state, make_train_step, source_inputs


def build(arch: str, *, smoke: bool, steps: int, lr: float, dtype,
          num_microbatches: int = 1):
    """(config, train step) with the trainer's AdamW settings."""
    cfg = registry.smoke_config(arch) if smoke else registry.get_config(arch)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(10, steps // 20))
    return cfg, make_train_step(cfg, opt_cfg, dtype=dtype,
                                num_microbatches=num_microbatches)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=(),
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card; cpu: the plain PyTorch path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    cfg, step_fn = build(args.arch, smoke=args.smoke, steps=args.steps,
                         lr=args.lr, dtype=dtype,
                         num_microbatches=args.micro)
    print(f"[train] {cfg.name}: {model.count_params(cfg):,} params "
          f"(family={cfg.family}) on {dev}")

    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed))
    state0 = {"params": params, "opt": opt}
    losses = []

    def loop_step(state, step):
        batch = synthetic_lm_batch(args.seed, step, batch=args.batch,
                                   seq=args.seq, vocab=cfg.vocab_size,
                                   device=dev)
        src = source_inputs(cfg, args.batch,
                            step_generator(args.seed, step, 1))
        batch.update({k: v.to(dev) for k, v in src.items()})
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 or step <= 3:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e}")

    loop = RestartableLoop(
        loop_step, args.ckpt_dir, checkpoint_every=args.ckpt_every,
        watchdog=StragglerWatchdog(),
        injector=FailureInjector(at_steps=tuple(args.fail_at)))
    t0 = time.time()
    result = loop.run(state0, args.steps, on_metrics=on_metrics)
    dt = time.time() - t0
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"[train] done: {result.step} steps in {dt:.1f}s; "
          f"loss {first:.4f} -> {last:.4f} "
          f"(restarts={loop.restarts}, "
          f"stragglers={len(loop.watchdog.stragglers)})")
    return 0 if last < first else 2


if __name__ == "__main__":
    raise SystemExit(main())
