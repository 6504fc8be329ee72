"""Structured errors of the WLSH-KRR port.

The solver and the serving stack raise these where the JAX package raises
its own, so callers can catch a bad input apart from a diverged solve, or a
shed request apart from a crashed worker, instead of matching messages.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base class for all structured errors of the port."""


class NonFiniteError(ReproError, ValueError):
    """Non-finite values where finite ones are required (NaN training
    target, Inf query row, poisoned table).  ``where`` names the array."""

    def __init__(self, message: str, *, where: str = "", count: int = 0):
        super().__init__(message)
        self.where = where
        self.count = int(count)


class SolveDivergedError(ReproError, ArithmeticError):
    """A solve ended with non-finite iterates/residuals after every
    configured fallback (precond -> identity restart)."""

    def __init__(self, message: str, *, resnorm=None, fallbacks=()):
        super().__init__(message)
        self.resnorm = resnorm
        self.fallbacks = tuple(fallbacks)


class WireOverflowError(ReproError, RuntimeError):
    """Hash-join routing dropped distinct buckets past the per-destination
    capacity (or zeroed non-finite wire cells) and the step ran with
    ``overflow='raise'``."""

    def __init__(self, message: str, *, dropped: int = 0):
        super().__init__(message)
        self.dropped = int(dropped)


# -- serving -----------------------------------------------------------------

class ServingError(ReproError):
    """Base class for request-path failures."""


class Overloaded(ServingError):
    """Request shed by queue-depth load shedding: a structured result the
    client can back off on, never a hang."""

    def __init__(self, message: str = "request shed: queue full", *,
                 queue_depth: int = 0):
        super().__init__(message)
        self.queue_depth = int(queue_depth)


class CircuitOpen(Overloaded):
    """Fast rejection while a circuit breaker is open.  Subclasses
    ``Overloaded`` so shed-handling backoff treats it alike;
    ``retry_after_s`` hints when the half-open probe window starts."""

    def __init__(self, message: str = "circuit open", *,
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExceeded(ServingError):
    """The request's deadline budget elapsed before its batch ran."""

    def __init__(self, message: str = "deadline exceeded", *,
                 waited_s: float = 0.0):
        super().__init__(message)
        self.waited_s = float(waited_s)


class WorkerCrashed(ServingError):
    """The batcher worker thread died; every in-flight future fails with
    this and later submits fail fast instead of hanging."""


class InvalidRequest(ServingError, ValueError):
    """Malformed request rejected before it reaches the model (non-finite
    query row, wrong dimensionality)."""


# -- test harness --------------------------------------------------------------

class FaultInjected(ReproError):
    """Raised by ``repro_torch.testing.faults`` when an armed fault fires —
    only ever seen under test control."""
