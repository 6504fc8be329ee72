"""Deterministic fault injection for the resilience layer (the hooks of
``repro.testing.faults``).

* wire cells  — ``apply_wire_fault`` drops or NaN-poisons all_to_all
                payload cells with Bernoulli masks drawn from
                ``torch.Generator().manual_seed(plan.seed)`` on the host:
                every rank, and every retry with the same plan, hits the
                same (destination, cell) pairs.  The masks are not JAX's
                bits (torch cannot reproduce ``jax.random``); the tests pin
                behaviour, not bits.
* shard stall — ``maybe_stall`` sleeps on one data rank before its step;
                the straggler holds up every collective it joins.
* checkpoint write — ``killed_checkpoint_writer`` arms a hook in
                ``checkpoint.store.save_checkpoint`` that raises between
                the array write and the atomic rename; ``preempt_after``
                raises from a fit's checkpoint callback (a preemption).
* batcher worker — ``crash_worker`` kills the MicroBatcher's worker thread
                outside its predict try/except; ``crash_supervised_workers``
                kills the next N workers a SupervisedBatcher spawns.
* predictor   — ``serve_fault`` stalls or fails warm-path calls per plan.
* artifact on disk — ``poison_artifact_tables`` scales a published
                artifact's tables in place (finite but wrong: the canary's
                catch); ``torn_publish`` exports under a killed writer
                (flat, or a sharded grid without its manifest); on one
                piece of a sharded grid, ``poison_piece`` scales it,
                ``nan_piece`` writes NaN, ``mixed_generation_publish``
                leaves it from the previous export.
* canary readout — ``canary_poison`` perturbs canary predictions only.
* solver      — ``poison_matvec`` makes one column of a matvec's output
                NaN (PCG's deactivation sentinel).

Host-side faults raise ``repro_torch.errors.FaultInjected``, so tests can
tell an injected fault from a genuine bug.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..errors import FaultInjected


class FaultPlan(NamedTuple):
    """Static description of the faults to inject; all fields default to
    'off'."""

    wire_drop_frac: float = 0.0    # fraction of wire cells zeroed (lost mass)
    wire_nan_frac: float = 0.0     # fraction of wire cells NaN-poisoned
    wire_nan_bf16_only: bool = False  # poison only bf16 payloads — the
                                      # f32-wire retry then runs clean
    seed: int = 0                  # seed of the cell masks
    stall_shard: int = -1          # data rank to stall (-1 = off)
    stall_s: float = 0.0           # stall per step call (host sleep)
    serve_delay_s: float = 0.0     # predictor warm-path stall per call
    serve_fail_every: int = 0      # raise FaultInjected every Nth warm call

    @property
    def wants_wire(self) -> bool:
        return self.wire_drop_frac > 0.0 or self.wire_nan_frac > 0.0


def apply_wire_fault(plan: FaultPlan | None,
                     payload: torch.Tensor) -> torch.Tensor:
    """Drop/poison cells of an all_to_all payload (n_shards, cap[, k]);
    returns ``payload`` itself when the plan injects nothing."""
    if plan is None or not plan.wants_wire:
        return payload
    nan_frac = plan.wire_nan_frac
    if plan.wire_nan_bf16_only and payload.dtype != torch.bfloat16:
        nan_frac = 0.0
    if plan.wire_drop_frac <= 0.0 and nan_frac <= 0.0:
        return payload
    cells = tuple(payload.shape[:2])
    gen = torch.Generator().manual_seed(plan.seed)
    drop = torch.rand(cells, generator=gen) < plan.wire_drop_frac
    nan = torch.rand(cells, generator=gen) < nan_frac
    drop, nan = drop.to(payload.device), nan.to(payload.device)
    if payload.ndim == 3:
        drop, nan = drop[..., None], nan[..., None]
    out = torch.where(drop, torch.zeros((), dtype=payload.dtype,
                                        device=payload.device), payload)
    return torch.where(nan, torch.full((), float("nan"), dtype=payload.dtype,
                                       device=payload.device), out)


def maybe_stall(plan: FaultPlan | None, data_rank: int) -> None:
    """Sleep ``plan.stall_s`` on data rank ``plan.stall_shard``."""
    if plan is None or plan.stall_s <= 0.0 or plan.stall_shard < 0:
        return
    if data_rank == plan.stall_shard:
        time.sleep(plan.stall_s)


@contextlib.contextmanager
def killed_checkpoint_writer(after_saves: int = 0):
    """Arm ``checkpoint.store``'s crash hook: the save that lands after
    ``after_saves`` clean ones raises ``FaultInjected`` between writing
    arrays.npz and the atomic rename, leaving a ``step_N.tmp`` dir with a
    full payload and no visibility to ``latest_step``.  A sharded export's
    manifest write counts as a save too (its last)."""
    from ..checkpoint import store
    counter = itertools.count()

    def boom(tmp_path: str) -> None:
        if next(counter) >= after_saves:
            raise FaultInjected(
                f"checkpoint writer killed mid-save in {tmp_path}")

    prev = store._crash_mid_save
    store._crash_mid_save = boom
    try:
        yield
    finally:
        store._crash_mid_save = prev


def preempt_after(n_checkpoints: int):
    """An ``on_solve_checkpoint`` callback that raises ``FaultInjected``
    after ``n_checkpoints`` checkpoints: a preemption mid-solve, with the
    last chunk's state already on disk."""
    counter = itertools.count(1)

    def hook(state) -> None:
        if next(counter) >= n_checkpoints:
            raise FaultInjected(
                f"solve preempted after checkpoint at it={int(state.it)}")

    return hook


def crash_worker(batcher, exc: BaseException | None = None) -> None:
    """Arm the MicroBatcher's fault hook so the next batch kills the worker
    thread itself (outside the predict try/except).  In-flight and queued
    futures must fail with ``WorkerCrashed``; later submits fail fast."""
    err = exc if exc is not None else FaultInjected("worker thread killed")

    def hook(batch) -> None:
        raise err

    batcher._fault_hook = hook


def serve_fault(plan: FaultPlan | None, call_idx: int) -> None:
    """Predictor warm-path injection: stall ``serve_delay_s`` per call and
    raise ``FaultInjected`` every ``serve_fail_every``-th call (1-based)."""
    if plan is None:
        return
    if plan.serve_delay_s > 0.0:
        time.sleep(plan.serve_delay_s)
    if plan.serve_fail_every > 0 and (call_idx % plan.serve_fail_every) == 0:
        raise FaultInjected(f"injected predict failure (call {call_idx})")


def poison_artifact_tables(directory: str, scale: float = 3.0) -> int:
    """Scale the ``tables`` entry of every published ``arrays.npz`` under
    ``directory`` by ``scale``, in place: finite but wrong, the damage
    structural validation cannot see.  The golden predictions recorded at
    export came from the healthy model, so the canary must reject it.
    Returns the number of payloads rewritten."""
    rewritten = 0
    for base, _dirs, files in os.walk(directory):
        if "arrays.npz" not in files or base.endswith(".tmp"):
            continue
        path = os.path.join(base, "arrays.npz")
        with np.load(path) as npz:
            arrays = {k: npz[k] for k in npz.files}
        keys = [k for k in arrays if "tables" in k]
        if not keys:
            continue
        for k in keys:
            arrays[k] = arrays[k] * np.float32(scale)
        np.savez(path, **arrays)
        rewritten += 1
    if rewritten == 0:
        raise FaultInjected(
            f"poison_artifact_tables: no tables payload under {directory}")
    return rewritten


@contextlib.contextmanager
def canary_poison(runtime, mode: str = "offset", magnitude: float = 1.0):
    """Arm a ServingRuntime's canary hook so canary predictions, and only
    those, come back offset by ``magnitude`` (``offset``) or non-finite
    (``nan``); the hosted model is untouched."""

    def hook(got):
        if mode == "nan":
            got[..., 0] = float("nan")
            return got
        return got + magnitude

    prev = runtime._canary_hook
    runtime._canary_hook = hook
    try:
        yield
    finally:
        runtime._canary_hook = prev


def torn_publish(directory: str, model, norm=None, *,
                 mesh_shape: tuple[int, int] | None = None,
                 after_saves: int = 0, **export_kwargs) -> None:
    """Export under a killed checkpoint writer, swallowing the injected
    crash: what a killed publisher leaves.  Flat: a ``step_N.tmp`` only.
    Sharded (``mesh_shape``): ``after_saves`` complete pieces and no
    manifest (the manifest counts as the export's last save, so
    ``after_saves`` = the number of pieces leaves every piece and no
    manifest).  The lifecycle watcher must treat the version as
    unpublished."""
    from ..serve.artifact import export_artifact, export_artifact_sharded

    with killed_checkpoint_writer(after_saves):
        try:
            if mesh_shape is not None:
                export_artifact_sharded(directory, model, norm=norm,
                                        mesh_shape=mesh_shape,
                                        **export_kwargs)
            else:
                export_artifact(directory, model, norm=norm, **export_kwargs)
        except FaultInjected:
            pass


def _piece_dir(directory: str, piece: tuple[int, int]) -> str:
    from ..serve.artifact import piece_name
    path = os.path.join(directory, piece_name(*piece))
    if not os.path.isdir(path):
        raise FaultInjected(f"no piece {piece} under {directory}")
    return path


def poison_piece(directory: str, piece: tuple[int, int],
                 scale: float = 3.0) -> int:
    """``poison_artifact_tables`` on ONE piece of a published sharded
    artifact: its tables scaled in place, finite but wrong (the canary's
    catch, when a golden query touches the piece)."""
    return poison_artifact_tables(_piece_dir(directory, piece), scale)


def nan_piece(directory: str, piece: tuple[int, int]) -> None:
    """Overwrite one piece's tables with NaN in place: the damage load-time
    validation must refuse (on the rank that reads the piece)."""
    path = _piece_dir(directory, piece)
    for base, _dirs, files in os.walk(path):
        if "arrays.npz" not in files or base.endswith(".tmp"):
            continue
        npz_path = os.path.join(base, "arrays.npz")
        with np.load(npz_path) as npz:
            arrays = {k: npz[k] for k in npz.files}
        for k in arrays:
            if "tables" in k:
                arrays[k] = np.full_like(arrays[k], np.nan)
        np.savez(npz_path, **arrays)


def mixed_generation_publish(directory: str, model, norm=None, *,
                             mesh_shape: tuple[int, int],
                             stale: tuple[int, int] = (0, 0),
                             **export_kwargs) -> None:
    """Publish a sharded version whose piece ``stale`` is from the export
    before the manifest's: export twice, then put the first export's piece
    back.  Its meta's ``export_version`` disagrees with the manifest, so
    the loader must refuse the grid (on the rank that reads the piece)."""
    import shutil

    from ..serve.artifact import export_artifact_sharded

    export_artifact_sharded(directory, model, norm=norm,
                            mesh_shape=mesh_shape, **export_kwargs)
    path = _piece_dir(directory, stale)
    keep = path + ".gen1"
    shutil.copytree(path, keep)
    export_artifact_sharded(directory, model, norm=norm,
                            mesh_shape=mesh_shape, **export_kwargs)
    shutil.rmtree(path)
    os.rename(keep, path)


def crash_supervised_workers(sup, crashes: int = 1,
                             exc: BaseException | None = None) -> None:
    """Arm a SupervisedBatcher so its next ``crashes`` workers die on their
    first batch (the supervisor re-arms the hook on every worker it spawns),
    then the next worker serves cleanly: the sequence that trips a breaker
    open and recovers it through a half-open probe."""
    err = exc if exc is not None else FaultInjected("worker thread killed")
    remaining = itertools.count(1)

    def hook(batch) -> None:
        n = next(remaining)
        if n <= crashes:
            if n >= crashes:
                sup._worker_fault_hook = None    # countdown spent: disarm
            raise err

    sup._worker_fault_hook = hook
    sup._mb._fault_hook = hook     # the current worker too


def poison_matvec(matvec, column: int = 0):
    """Wrap a (n,)/(n, k) matvec so ``column`` of its output is NaN — the
    single-host analogue of a poisoned wire cell.  ``pcg_solve`` must
    deactivate that column (NaN resnorm sentinel) while the others converge
    untouched."""

    def wrapped(v):
        out = matvec(v)
        if out.ndim == 1:
            return out + float("nan") if column == 0 else out
        out = out.clone()
        out[:, column] = float("nan")
        return out

    return wrapped
