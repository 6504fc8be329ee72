"""Kernel ridge regression solvers.

* ``pcg_solve`` — preconditioned (block-)CG on (A + lam I) with an arbitrary
  matvec; ``b`` is (n,) or an (n, k) block.  Convergence is tracked per
  column and converged columns are deflated.  A column whose step goes
  non-finite is deactivated before the bad update lands (resnorm NaN).  The
  loop runs on the host: its ``any(active)`` test syncs once per iteration.
  Two obs timers split an iteration's host time: ``pcg.issue`` (issuing
  its work, no sync) and ``pcg.wait`` (the convergence test, blocked until
  the device has finished the work before it).
* ``cg_solve`` — the unpreconditioned single-RHS entry point over
  ``pcg_solve``, with its scalar ``CGResult``.
* ``exact_krr_fit`` / ``exact_krr_predict`` — the dense baseline.
* ``wlsh_krr_fit`` / ``wlsh_krr_predict`` — the paper's §4.2 algorithm:
  solve (K~ + lam I) beta = y with PCG (on the CountSketch or the exact
  estimator), predict via bucket loads.  A fit's phases are the obs spans
  ``fit.featurize``, ``fit.layout``, ``fit.pcg`` and ``fit.tables``; a
  predict call is the span ``predict``.

Everything runs through ``core.operator.WLSHOperator`` on one device.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import obs
from ..backend import as_tensor, resolve_device
from ..errors import NonFiniteError, SolveDivergedError
from .bucket_fns import get_bucket_fn
from .kernels import WLSHKernelSpec
from .lsh import LSHParams
from .operator import WLSHOperator, default_table_size, make_operator
from .precond import (DEFAULT_NYSTROM_RANK, Preconditioner, identity_precond,
                      make_preconditioner, table_diag)

MatVec = Callable[[torch.Tensor], torch.Tensor]

_ISSUE = obs.timer("pcg.issue")   # one iteration's host issue
_WAIT = obs.timer("pcg.wait")     # one convergence test (the loop's sync)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    resnorm: torch.Tensor


class PCGResult(NamedTuple):
    x: torch.Tensor          # (n,) or (n, k)
    iters: int               # block iterations run
    col_iters: torch.Tensor  # (k,) int32 iteration each column converged at
    resnorm: torch.Tensor    # (k,) final per-column ||r||
    resnorm_history: torch.Tensor  # (maxiter+1, k), NaN past the last row


class SolveState(NamedTuple):
    """PCG state after ``it`` iterations, always in the 2-D block form, so a
    solve continues exactly where it left off."""

    x: torch.Tensor          # (n, k)
    r: torch.Tensor          # (n, k)
    p: torch.Tensor          # (n, k)
    rs: torch.Tensor         # (k,) ||r||^2 (NaN = deactivated)
    rho: torch.Tensor        # (k,)
    active: torch.Tensor     # (k,) bool
    it: int
    col_iters: torch.Tensor  # (k,) int32


def solve_state_template(b) -> SolveState:
    """Zero-filled ``SolveState`` (numpy leaves) shaped for the RHS ``b``:
    the restore template for ``checkpoint.restore_checkpoint``.  ``it`` is a
    0-d int32 array, as the JAX package stores it."""
    n = b.shape[0]
    k = 1 if b.ndim == 1 else b.shape[1]
    zk = np.zeros((k,), np.float32)
    znk = np.zeros((n, k), np.float32)
    return SolveState(x=znk, r=znk.copy(), p=znk.copy(), rs=zk,
                      rho=zk.copy(), active=np.zeros((k,), bool),
                      it=np.zeros((), np.int32),
                      col_iters=np.zeros((k,), np.int32))


def _stored_solve_state(state: SolveState) -> SolveState:
    """``state`` in the stored form: ``it`` as a 0-d int32 array."""
    return state._replace(it=np.asarray(state.it, np.int32))


def load_solve_state(directory: str, b: torch.Tensor) -> SolveState | None:
    """Latest persisted ``SolveState`` under ``directory`` (written by either
    package), on ``b``'s device; None when the directory holds no complete
    checkpoint (a fresh solve)."""
    from ..checkpoint.store import latest_step, restore_checkpoint
    if latest_step(directory) is None:
        return None
    state, _, _ = restore_checkpoint(directory, solve_state_template(b))
    tensors = {name: torch.from_numpy(np.array(getattr(state, name))).to(
        b.device) for name in SolveState._fields if name != "it"}
    return SolveState(it=int(state.it), **tensors)


def pcg_solve(matvec: MatVec, b: torch.Tensor, lam: float, *,
              precond: Preconditioner | None = None, tol: float = 1e-6,
              atol: float = 1e-12, maxiter: int = 200,
              x0: torch.Tensor | None = None,
              state: SolveState | None = None, checkpoint_every: int = 0,
              on_checkpoint: Callable[[SolveState], None] | None = None,
              ) -> PCGResult:
    """Solve (A + lam I) X = B by preconditioned CG (see the JAX package's
    ``pcg_solve`` for the recurrences, which this follows line by line).

    Column j converges when ||r_j|| <= max(tol ||b_j||, atol).  ``x0``
    (shaped as ``b``) starts the iterates there instead of at 0; a given
    ``state`` takes precedence over it.  With
    ``checkpoint_every > 0`` the loop runs in chunks of that many iterations
    and calls ``on_checkpoint(state)`` after each; pass a ``state`` to
    resume from it.  For a 1-D ``b`` the matvec only sees 1-D vectors."""
    vec = b.ndim == 1
    inner_mv = (lambda v: matvec(v[:, 0])[:, None]) if vec else matvec
    b2 = b[:, None] if vec else b
    eps = torch.tensor(1e-30, dtype=b2.dtype, device=b2.device)
    maxiter = int(maxiter)
    psolve = (identity_precond() if precond is None else precond).apply

    def amv(v):
        return inner_mv(v) + lam * v

    bnorm = torch.sqrt((b2 * b2).sum(0))
    thresh = (tol * bnorm).clamp(min=atol) ** 2
    hist = torch.full((maxiter + 1, b2.shape[1]), float("nan"),
                      dtype=b2.dtype, device=b2.device)
    if state is None:
        if x0 is None:
            x = torch.zeros_like(b2)
        else:
            x = (x0[:, None] if vec else x0).to(b2.dtype)
        r = b2 - amv(x)
        z = psolve(r)
        rs = (r * r).sum(0)
        rho = (r * z).sum(0)
        active = rs > thresh
        p = torch.where(active[None, :], z, 0.0)
        col_iters = torch.where(active, maxiter, 0).to(torch.int32)
        state = SolveState(x=x, r=r, p=p, rs=rs, rho=rho, active=active,
                           it=0, col_iters=col_iters)
    hist[state.it] = torch.sqrt(state.rs)
    chunk = int(checkpoint_every) if checkpoint_every > 0 else maxiter

    def step(st: SolveState) -> SolveState:
        x, r, p, rs, rho, active, it, col_iters = st
        ap = amv(p)
        denom = (p * ap).sum(0)
        alpha = rho / torch.maximum(denom, eps)
        ok = active & torch.isfinite(alpha)
        alpha = torch.where(ok, alpha, 0.0)
        x = x + torch.where(ok[None, :], alpha[None, :] * p, 0.0)
        r = r - torch.where(ok[None, :], alpha[None, :] * ap, 0.0)
        rs = (r * r).sum(0)
        rs = torch.where(active & ~ok, float("nan"), rs)
        hist[it + 1] = torch.sqrt(rs)
        still = (rs > thresh) & torch.isfinite(rs)
        col_iters = torch.where(active & ~still, it + 1, col_iters).to(
            torch.int32)
        active = active & still
        z = psolve(r)
        rho_new = (r * z).sum(0)
        beta = torch.where(active, rho_new / torch.maximum(rho, eps), 0.0)
        p = torch.where(active[None, :], z + beta[None, :] * p, 0.0)
        return SolveState(x, r, p, rs, rho_new, active, it + 1, col_iters)

    def live(st: SolveState) -> bool:
        with _WAIT():
            return bool(st.active.any())

    while True:
        steps = 0
        while steps < chunk and state.it < maxiter and live(state):
            with _ISSUE():
                state = step(state)
            steps += 1
        if on_checkpoint is not None:
            on_checkpoint(state)
        if state.it >= maxiter or not live(state):
            break
    return PCGResult(x=state.x[:, 0] if vec else state.x, iters=state.it,
                     col_iters=state.col_iters, resnorm=torch.sqrt(state.rs),
                     resnorm_history=hist)


def cg_solve(matvec: MatVec, b: torch.Tensor, lam: float, *,
             tol: float = 1e-6, atol: float = 1e-12, maxiter: int = 200,
             x0: torch.Tensor | None = None) -> CGResult:
    """Unpreconditioned CG over ``pcg_solve``: for a 1-D ``b`` the
    iteration count and resnorm are scalars."""
    res = pcg_solve(matvec, b, lam, tol=tol, atol=atol, maxiter=maxiter,
                    x0=x0)
    squeeze = b.ndim == 1
    return CGResult(x=res.x,
                    iters=res.col_iters[0] if squeeze
                    else torch.tensor(res.iters),
                    resnorm=res.resnorm[0] if squeeze else res.resnorm)


# ---------------------------------------------------------------------------
# exact KRR (dense baseline)
# ---------------------------------------------------------------------------

def exact_krr_fit(kernel_fn, x: torch.Tensor, y: torch.Tensor,
                  lam: float) -> torch.Tensor:
    k = kernel_fn(x, x)
    a = k + lam * torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
    return torch.linalg.solve(a, y)


def exact_krr_predict(kernel_fn, x_train: torch.Tensor, beta: torch.Tensor,
                      x_test: torch.Tensor) -> torch.Tensor:
    return kernel_fn(x_test, x_train) @ beta


# ---------------------------------------------------------------------------
# WLSH approximate KRR (paper §4.2)
# ---------------------------------------------------------------------------

class WLSHKRRModel(NamedTuple):
    lsh: LSHParams
    bucket_name: str
    beta: torch.Tensor     # (n,) or (n, k) PCG solution
    tables: torch.Tensor   # (m, B[, k]) bucket loads of beta
    table_size: int
    cg_iters: torch.Tensor
    cg_resnorm: torch.Tensor
    precond: str = "none"
    cg_col_iters: torch.Tensor | None = None
    solve_fallback: str = ""
    # host-side solve summary: resnorm_history ((iters+1, k) float32),
    # col_iters, iters, precond, fallback, and phase_seconds (the durations
    # of the spans fit.featurize, .layout, .pcg and .tables, each ended by
    # a device sync).  phase_seconds is {} while obs tracing is off
    # (obs.set_tracing(False)): every reader of it must allow for that, as
    # the benchmark's pcg_ms and layout_ms readers, which index it, do not
    telemetry: dict | None = None


def model_operator(model: WLSHKRRModel) -> WLSHOperator:
    """The operator a fitted model predicts with, on its tables' device."""
    return make_operator(model.lsh, get_bucket_fn(model.bucket_name),
                         model.table_size, device=model.tables.device)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@contextlib.contextmanager
def _phase(name: str, device: torch.device, seconds: dict):
    """The span ``fit.<name>`` over the block, ended on a device sync so that
    it holds the device work the block issued; its duration goes to
    ``seconds[name]``.  With obs tracing off: the bare block, no sync."""
    if not obs.tracing_enabled():
        yield
        return
    with obs.span(f"fit.{name}") as sp:
        yield
        _sync(device)
    seconds[name] = sp.duration_us * 1e-6


def wlsh_krr_fit(lsh: LSHParams, x, y, spec: WLSHKernelSpec, *, lam: float,
                 mode: str = "table", table_size: int = 0,
                 tol: float = 1e-5, atol: float = 1e-12, maxiter: int = 400,
                 precond: str = "none",
                 precond_rank: int = DEFAULT_NYSTROM_RANK,
                 nonfinite_targets: str = "raise", device=None,
                 fused: bool = True,
                 solve_checkpoint_dir: str | None = None,
                 solve_checkpoint_every: int = 0,
                 on_solve_checkpoint=None) -> WLSHKRRModel:
    """Fit WLSH-KRR with the m instances of ``lsh`` on ``device`` (None:
    the card, raising without one).  ``y`` is (n,) or an (n, k) block.

    ``mode`` picks the estimator PCG solves with: 'table' (CountSketch) or
    'exact' (the sorted-bucket estimator of Def. 6, Jacobi diagonal
    mean_s weight^2).  The prediction tables are CountSketch either way; in
    exact mode they come from the point scatter (B5), as no layout is
    built.

    ``fused`` runs every table-mode PCG matvec as one pass over the
    slot-blocked layout; ``fused=False`` builds no layout and runs the
    split scatter -> gather matvec (B5 then B4) for A/B runs.  The fitted
    model agrees either way to float rounding.

    ``precond`` is 'none' | 'jacobi' | 'nystrom'.  ``nonfinite_targets``:
    'raise' rejects NaN/Inf in x or y with ``NonFiniteError``; 'deactivate'
    lets the solver's sentinels freeze the poisoned columns.  A non-finite
    residual under a preconditioner restarts once with the identity; still
    non-finite iterates raise ``SolveDivergedError``.
    ``on_solve_checkpoint(state)`` is called every
    ``solve_checkpoint_every`` iterations.  ``solve_checkpoint_dir``
    persists the state there at that interval (default maxiter // 10)
    through ``checkpoint/store.py``, in the JAX package's format, and
    resumes from the newest complete state in it: a preempted fit restarted
    with the same arguments continues where it left off, whichever package
    wrote the state."""
    if nonfinite_targets not in ("raise", "deactivate"):
        raise ValueError(f"nonfinite_targets must be 'raise' or "
                         f"'deactivate', got {nonfinite_targets!r}")
    if mode not in ("table", "exact"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    if nonfinite_targets == "raise":
        for name, arr in (("x", x), ("y", y)):
            bad = int((~torch.isfinite(arr)).sum())
            if bad:
                raise NonFiniteError(
                    f"{bad} non-finite value(s) in training {name}; clean "
                    f"the data or pass nonfinite_targets='deactivate'",
                    where=name, count=bad)
    n = x.shape[0]
    if table_size <= 0:
        table_size = default_table_size(n)
    op = make_operator(lsh, get_bucket_fn(spec.bucket.name), table_size,
                       device=dev, fused=fused)

    seconds: dict = {}
    if obs.tracing_enabled():
        _sync(dev)          # the first span holds none of the work before it
    with _phase("featurize", dev, seconds):
        feats = op.featurize(x)
    with _phase("layout", dev, seconds):
        tidx = op.build_index(feats, blocked=fused and mode == "table")
        if mode == "exact":
            eidx = op.build_index(feats, mode="exact")
            mv = lambda v: op.matvec(eidx, v)
            diag = (eidx.weight * eidx.weight).mean(0)
        else:
            mv = lambda v: op.matvec(tidx, v)
            diag = table_diag(tidx.coeff)
        del feats
    with _phase("pcg", dev, seconds):
        pre = make_preconditioner(precond, matvec=mv, diag=diag, lam=lam,
                                  rank=precond_rank)
        state = None
        every = int(solve_checkpoint_every)
        on_ck = on_solve_checkpoint if every > 0 else None
        if solve_checkpoint_dir:
            from ..checkpoint.store import CheckpointManager
            if every <= 0:
                every = max(1, maxiter // 10)
            mgr = CheckpointManager(solve_checkpoint_dir, keep=2)
            state = load_solve_state(solve_checkpoint_dir, y)

            def on_ck(st):
                # persist first, then call the hook: a preemption the hook
                # injects leaves this chunk's state on disk
                mgr.save(int(st.it), _stored_solve_state(st), blocking=True)
                if on_solve_checkpoint is not None:
                    on_solve_checkpoint(st)

        res = pcg_solve(mv, y, lam, precond=pre, tol=tol, atol=atol,
                        maxiter=maxiter, state=state, checkpoint_every=every,
                        on_checkpoint=on_ck)
        fallback = ""
        if precond not in ("none", None) and \
                not bool(torch.isfinite(res.resnorm).all()):
            warnings.warn(f"PCG with precond={precond!r} went non-finite; "
                          f"restarting once with the identity "
                          f"preconditioner", RuntimeWarning, stacklevel=2)
            fallback = f"precond:{precond}->identity"
            res = pcg_solve(mv, y, lam, precond=None, tol=tol, atol=atol,
                            maxiter=maxiter)
        if not bool(torch.isfinite(res.x).all()):
            raise SolveDivergedError(
                "PCG iterates are non-finite after all fallbacks",
                resnorm=res.resnorm.cpu().numpy(),
                fallbacks=(fallback,) if fallback else ())
    with _phase("tables", dev, seconds):
        tables = op.loads(tidx, res.x)
    squeeze = y.ndim == 1
    telemetry = {
        "resnorm_history": res.resnorm_history[: res.iters + 1]
        .cpu().numpy().astype(np.float32),
        "col_iters": res.col_iters.cpu().numpy().astype(np.int32),
        "iters": int(res.iters),
        "precond": precond,
        "fallback": fallback,
        "phase_seconds": seconds,
    }
    return WLSHKRRModel(lsh=op.lsh, bucket_name=spec.bucket.name, beta=res.x,
                        tables=tables, table_size=int(table_size),
                        cg_iters=res.col_iters[0] if squeeze
                        else torch.tensor(res.iters),
                        cg_resnorm=res.resnorm[0] if squeeze
                        else res.resnorm,
                        precond=precond, cg_col_iters=res.col_iters,
                        solve_fallback=fallback, telemetry=telemetry)


def wlsh_krr_predict(model: WLSHKRRModel, x_test, *,
                     batch_size: int | None = None) -> torch.Tensor:
    """Predict at x_test from the model's tables, streaming blocks of
    ``batch_size`` points; a (n, k) fit predicts (n_test, k).  The span
    ``predict`` holds the call's host time, up to its return (the device
    may still be working)."""
    with obs.span("predict"):
        op = model_operator(model)
        return op.predict_batched(model.tables, x_test,
                                  batch_size=batch_size)
