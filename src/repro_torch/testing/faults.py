"""Deterministic fault injection for the distributed step's resilience
layer (the wire and stall hooks of ``repro.testing.faults``; the serving
hooks wait for the serving slice).

* wire cells  — ``apply_wire_fault`` drops or NaN-poisons all_to_all
                payload cells with Bernoulli masks drawn from
                ``torch.Generator().manual_seed(plan.seed)`` on the host:
                every rank, and every retry with the same plan, hits the
                same (destination, cell) pairs.  The masks are not JAX's
                bits (torch cannot reproduce ``jax.random``); the tests pin
                behaviour, not bits.
* shard stall — ``maybe_stall`` sleeps on one data rank before its step;
                the straggler holds up every collective it joins.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch


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
