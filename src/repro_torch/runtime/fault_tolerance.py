"""Fault tolerance: restartable training loop, failure injection, straggler
watchdog.  The port of ``repro.runtime.fault_tolerance``.

The contract:

* every N steps the state is checkpointed (asynchronous and atomic, in the
  JAX package's format: ``repro_torch.checkpoint``);
* any exception in the step function triggers restore-from-latest and
  replay; the data pipeline is a pure function of (seed, step)
  (``repro_torch.data.tokens``), so replayed steps consume exactly the
  batches they would have consumed;
* a watchdog tracks each step's wall time against a rolling median,
  records outliers, and aborts a step past a hard timeout so the restart
  path engages.

``FailureInjector`` raises at chosen steps so tests and the trainer can
exercise the whole path on one host.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..checkpoint import CheckpointManager, latest_step, restore_like

log = logging.getLogger("repro_torch.runtime")


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raises InjectedFailure the first time each step in ``at_steps`` runs."""
    at_steps: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclass
class StragglerWatchdog:
    """Rolling-median step-time monitor with a hard timeout."""
    slow_factor: float = 3.0
    hard_timeout_s: float = 0.0       # 0 disables
    window: int = 32
    times: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> None:
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        if len(hist) >= 8 and dt > self.slow_factor * med:
            self.stragglers.append((step, dt, med))
            log.warning("straggler: step %d took %.3fs (median %.3fs)",
                        step, dt, med)
        if self.hard_timeout_s and dt > self.hard_timeout_s:
            raise TimeoutError(
                f"step {step} exceeded hard timeout {self.hard_timeout_s}s "
                f"({dt:.3f}s) — aborting for restart")


@dataclass
class StepResult:
    state: Any
    metrics: dict
    step: int


class RestartableLoop:
    """Checkpointed, crash-tolerant training loop.

    step_fn(state, step) -> (state, metrics) must be a pure function of its
    inputs (the train step closed over the batch source): it must not
    change the state it is given, since the initial state is the restart
    point before the first checkpoint.  The state is any tree of dicts,
    NamedTuples and tensors.  The loop retries from the latest complete
    checkpoint on any exception, up to ``max_restarts`` times.
    """

    def __init__(self, step_fn: Callable[[Any, int], tuple[Any, dict]],
                 ckpt_dir: str, *, checkpoint_every: int = 25, keep: int = 3,
                 max_restarts: int = 8,
                 watchdog: StragglerWatchdog | None = None,
                 injector: FailureInjector | None = None):
        self.step_fn = step_fn
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.watchdog = watchdog or StragglerWatchdog()
        self.injector = injector
        self.restarts = 0

    def _resume(self, state: Any) -> tuple[Any, int]:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return state, 0
        restored, step, _ = restore_like(self.ckpt_dir, state)
        log.info("resumed from checkpoint step %d", step)
        return restored, step

    def run(self, init_state: Any, num_steps: int,
            on_metrics: Callable[[int, dict], None] | None = None
            ) -> StepResult:
        state, start = self._resume(init_state)
        step = start
        metrics: dict = {}
        while step < num_steps:
            try:
                t0 = time.monotonic()
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                state, metrics = self.step_fn(state, step)
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()    # the step's device work
                self.watchdog.observe(step, time.monotonic() - t0)
                step += 1
                if step % self.checkpoint_every == 0 or step == num_steps:
                    self.manager.save(step, state, meta={"step": step})
                if on_metrics is not None:
                    on_metrics(step, metrics)
            except Exception as exc:  # noqa: BLE001 — the whole point
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restart %d/%d", step, exc,
                            self.restarts, self.max_restarts)
                self.manager.wait()
                state, step = self._resume(init_state)
        self.manager.wait()
        return StepResult(state=state, metrics=metrics, step=step)
