"""Structured errors of the WLSH-KRR port.

The solver raises these where the JAX package raises its own, so callers can
catch a bad input apart from a diverged solve instead of matching messages.
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
