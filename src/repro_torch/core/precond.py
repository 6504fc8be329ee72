"""Preconditioners for the WLSH-KRR PCG solve.

* **jacobi** — the exact diagonal of the CountSketch operator,
  diag(K~)_i = mean_s coeff[s, i]^2.
* **nystrom** — a rank-r pivoted Nyström approximation: pivot columns
  C = K~[:, piv] from ONE multi-RHS matvec on r one-hot columns, pivots the r
  largest diagonal entries (ties to the lower index, as ``jax.lax.top_k``:
  a stable descending sort, since ``torch.topk`` breaks ties otherwise).
  With A = C W (W whitens the pivot block) P = A A^T + lam I, inverted by
  Woodbury through the Cholesky factor of lam I + A^T A.

``Preconditioner.apply`` takes r of shape (n,) or (n, k).  The products are
float32 matmuls: keep ``torch.backends.cuda.matmul.allow_tf32`` off.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

PRECOND_NAMES = ("none", "jacobi", "nystrom")
DEFAULT_NYSTROM_RANK = 128


class Preconditioner(NamedTuple):
    """z = apply(r) ~ (K~ + lam I)^-1 r, for r of shape (n,) or (n, k)."""

    name: str
    apply: Callable[[torch.Tensor], torch.Tensor]


def identity_precond() -> Preconditioner:
    return Preconditioner(name="none", apply=lambda r: r)


def table_diag(coeff: torch.Tensor, *, average: bool = True) -> torch.Tensor:
    """diag(K~) from a TableIndex's coeff (m, n): mean_s coeff^2."""
    sq = coeff * coeff
    return sq.mean(0) if average else sq.sum(0)


def jacobi_precond(diag: torch.Tensor, lam: float) -> Preconditioner:
    d = diag + lam

    def apply(r):
        return r / d if r.ndim == 1 else r / d[:, None]

    return Preconditioner(name="jacobi", apply=apply)


class NystromFactors(NamedTuple):
    pivots: torch.Tensor      # (r,) int64, largest diagonal first
    a: torch.Tensor           # (n, r) whitened pivot columns
    chol_small: torch.Tensor  # (r, r) lower Cholesky of lam I + A^T A
    lam: float


def nystrom_factors(matvec, diag: torch.Tensor, lam: float, rank: int, *,
                    jitter: float = 1e-6) -> NystromFactors:
    """One multi-RHS matvec + two small factorizations; O(n r^2) flops.
    The pivot block is whitened through its eigendecomposition with a
    relative eigenvalue floor (directions below it are dropped)."""
    n = diag.shape[0]
    r = min(int(rank), n)
    pivots = torch.sort(diag, descending=True, stable=True).indices[:r]
    onehot = torch.zeros((n, r), dtype=torch.float32, device=diag.device)
    onehot[pivots, torch.arange(r, device=diag.device)] = 1.0
    cols = matvec(onehot)                                  # (n, r)
    small = cols[pivots]
    small = 0.5 * (small + small.T)
    evals, evecs = torch.linalg.eigh(small)
    floor = evals.max().clamp(min=0.0) * jitter + 1e-30
    inv_sqrt = torch.where(evals > floor,
                           1.0 / torch.sqrt(torch.maximum(evals, floor)), 0.0)
    a = cols @ (evecs * inv_sqrt[None, :])
    eye = torch.eye(r, dtype=a.dtype, device=a.device)
    chol_small = torch.linalg.cholesky(lam * eye + a.T @ a)
    return NystromFactors(pivots=pivots, a=a, chol_small=chol_small,
                          lam=float(lam))


def nystrom_precond(matvec, diag: torch.Tensor, lam: float, rank: int, *,
                    jitter: float = 1e-6) -> Preconditioner:
    fac = nystrom_factors(matvec, diag, lam, rank, jitter=jitter)

    def apply(rhs):
        rr = rhs[:, None] if rhs.ndim == 1 else rhs
        t = fac.a.T @ rr
        u = torch.linalg.solve_triangular(
            fac.chol_small.T,
            torch.linalg.solve_triangular(fac.chol_small, t, upper=False),
            upper=True)
        z = (rr - fac.a @ u) / fac.lam
        return z[:, 0] if rhs.ndim == 1 else z

    return Preconditioner(name="nystrom", apply=apply)


def make_preconditioner(name: str, *, matvec=None, diag=None,
                        lam: float = 0.0, rank: int = DEFAULT_NYSTROM_RANK,
                        jitter: float = 1e-6) -> Preconditioner:
    """'none' | 'jacobi' (needs diag) | 'nystrom' (needs diag and matvec)."""
    if name == "none" or name is None:
        return identity_precond()
    if name == "jacobi":
        if diag is None:
            raise ValueError("jacobi preconditioner needs diag")
        return jacobi_precond(diag, lam)
    if name == "nystrom":
        if diag is None or matvec is None:
            raise ValueError("nystrom preconditioner needs diag and matvec")
        return nystrom_precond(matvec, diag, lam, rank, jitter=jitter)
    raise ValueError(f"unknown preconditioner {name!r}; "
                     f"expected one of {PRECOND_NAMES}")
