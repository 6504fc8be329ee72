"""Self-healing serving runtime: reload, canary, rollback, supervision.

Closes the loop from the obs layer's signals to recovery actions
(DESIGN.md §12).  Three cooperating pieces:

* ``ServingRuntime`` — a version WATCHER over a directory of published
  artifact versions (``<root>/v1``, ``<root>/v2``, ... — each a complete
  flat artifact).  ``poll_once`` discovers the newest published
  version, loads it ALONGSIDE the serving one (transient-retrying torn
  reads), captures its padding buckets' graphs, CANARY-validates it against the
  golden query set captured at export time (predictions must agree with the
  recorded outputs within the pinned tolerance and be finite), and only then
  atomically swaps the active version — a single tuple flip, so a concurrent
  ``predict`` sees exactly the old or the new version, never a mix, and warm
  buckets are never captured again across a swap.  The previous N versions stay
  hosted for INSTANT rollback: when post-swap health regresses within the
  probation window (model-error rate over threshold, or any non-finite
  prediction), the runtime flips back and quarantines the bad version.
  Torn publishes are invisible (a version with no completed checkpoint
  step is skipped, exactly like a torn single artifact); canary-rejected
  and structurally-invalid versions are remembered and never re-tried.
  A replaced version's graphs and tables are released when it is
  unloaded and no predict holds it any more.

* ``SupervisedBatcher`` — a MicroBatcher under supervision: a worker crash
  is no longer terminal.  The crash fails the in-flight batch (WorkerCrashed,
  as before), the supervisor restarts a fresh worker with exponential
  backoff, and a per-model ``CircuitBreaker`` converts repeated failures
  into fast ``CircuitOpen`` (an ``Overloaded`` subclass) rejections instead
  of piling callers onto a sick model.

* ``CircuitBreaker`` — classic closed -> open -> half-open machine: opens
  after ``failure_threshold`` consecutive failures, admits
  ``half_open_probes`` probe requests after ``cooldown_s``, re-closes when
  they succeed, re-opens when one fails.

Every transition is an obs series (``lifecycle_*`` / ``breaker_*``) and
surfaces in ``health()`` — a runtime registered as a health provider turns
``/healthz`` into a live view of active version, retained rollback targets,
probation state, and breaker state.

The port's copy of the JAX package's module.  With ``mesh_shape`` (or a
``ShardedPredictor``) the versions are sharded piece grids and the runtime
runs on rank 0 of the grid: its loads, canary predicts and unloads reach
every rank as the predictor's commands, so canary, swap and rollback act
on the whole grid.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import NamedTuple

import numpy as np

from .. import obs
from ..checkpoint.store import latest_step
from ..errors import (CircuitOpen, DeadlineExceeded, InvalidRequest,
                      Overloaded, ServingError, WorkerCrashed)
from .artifact import MANIFEST_NAME, load_artifact
from .batcher import MicroBatcher
from .predictor import DEFAULT_MAX_BATCH, Predictor
from .sharded import ShardedPredictor

_VERSION_RE = re.compile(r"^v(\d+)$")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


# ---------------------------------------------------------------------------
# version discovery
# ---------------------------------------------------------------------------

def version_dir(root: str, version: int) -> str:
    """``<root>/v<version>`` — the publish convention the watcher polls."""
    return os.path.join(root, f"v{int(version)}")


def discover_versions(root: str, *, sharded: bool = False
                      ) -> list[tuple[int, str]]:
    """Sorted ``[(version, path)]`` of PUBLISHED versions under ``root``.

    A version is published once its artifact is loadable at all: a flat
    version needs a completed checkpoint step (a ``step_N.tmp`` left by a
    killed writer is invisible, as everywhere else), a sharded one its
    manifest (written last by ``export_artifact_sharded``, so pieces
    without one are a publish in progress).  Non-``v<N>`` entries are
    ignored — exporters may keep scratch space next to the versions.
    """
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _VERSION_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if sharded:
            if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
                continue
        elif latest_step(path) is None:
            continue
        out.append((int(m.group(1)), path))
    return sorted(out)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """closed -> open -> half-open request gate, per model.

    ``admit()`` raises ``CircuitOpen`` while open (and past the half-open
    probe quota); callers report outcomes with ``record_success`` /
    ``record_failure`` (``record_neutral`` returns an admitted probe's slot
    when the request died of a NON-model condition — shed, deadline — so a
    starved probe can't wedge the half-open state).  State and transitions
    are obs series labeled by the breaker name.
    """

    def __init__(self, *, name: str = "default", failure_threshold: int = 3,
                 cooldown_s: float = 0.25, half_open_probes: int = 1,
                 clock=time.monotonic):
        if failure_threshold < 1 or half_open_probes < 1:
            raise ValueError("failure_threshold and half_open_probes must "
                             "be >= 1")
        self.name = str(name)
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probes_issued = 0
        self._probe_successes = 0
        self._n_rejected = 0
        self._m_state = obs.gauge(
            "breaker_state", "circuit state (0 closed, 1 open, 2 half-open)",
            labels=("model",)).labels(self.name)
        self._m_transitions = obs.counter(
            "breaker_transitions_total", "circuit state transitions",
            labels=("model", "to"))
        self._m_rejections = obs.counter(
            "breaker_rejections_total",
            "submits rejected fast while the circuit is open",
            labels=("model",)).labels(self.name)
        self._m_state.set(0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _to(self, state: str) -> None:
        # lock held by caller
        if state == self._state:
            return
        self._state = state
        if state == HALF_OPEN:
            self._probes_issued = 0
            self._probe_successes = 0
        elif state == OPEN:
            self._opened_at = self._clock()
        else:
            self._consecutive = 0
        self._m_state.set(_STATE_CODE[state])
        self._m_transitions.labels(self.name, state).inc()

    def admit(self) -> None:
        """Gate one request; raises ``CircuitOpen`` instead of letting it
        reach a sick model."""
        with self._lock:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                waited = self._clock() - self._opened_at
                if waited < self.cooldown_s:
                    self._n_rejected += 1
                    self._m_rejections.inc()
                    raise CircuitOpen(
                        f"breaker {self.name!r} open "
                        f"({self._consecutive} consecutive failures)",
                        retry_after_s=self.cooldown_s - waited)
                self._to(HALF_OPEN)
            if self._probes_issued >= self.half_open_probes:
                self._n_rejected += 1
                self._m_rejections.inc()
                raise CircuitOpen(
                    f"breaker {self.name!r} half-open: probe quota "
                    f"({self.half_open_probes}) already in flight")
            self._probes_issued += 1

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._to(CLOSED)
            else:
                self._consecutive = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._to(OPEN)
                return
            self._consecutive += 1
            if self._state == CLOSED \
                    and self._consecutive >= self.failure_threshold:
                self._to(OPEN)

    def record_neutral(self) -> None:
        """An admitted request resolved without indicting the model (shed,
        deadline-expired, invalid input): hand a half-open probe slot back."""
        with self._lock:
            if self._state == HALF_OPEN and self._probes_issued > 0:
                self._probes_issued -= 1

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "rejected": self._n_rejected}


# ---------------------------------------------------------------------------
# supervised batcher
# ---------------------------------------------------------------------------

class SupervisedBatcher:
    """A MicroBatcher whose worker crashes are recovered, not terminal.

    The in-flight batch of a crashing worker still fails with
    ``WorkerCrashed`` (nothing can finish it), but the NEXT submit restarts
    a fresh worker after an exponential backoff instead of failing fast
    forever.  Every crash (and every model-error batch outcome) feeds the
    per-model circuit breaker, so sustained sickness turns into fast
    ``CircuitOpen`` rejections and a half-open probe is what re-admits
    traffic after the cooldown.  API-compatible with ``MicroBatcher`` where
    the serving drivers touch it (submit / predict / stats / close /
    context manager).
    """

    def __init__(self, predict_fn, *, name: str = "default",
                 breaker: CircuitBreaker | None = None,
                 failure_threshold: int = 3, cooldown_s: float = 0.25,
                 half_open_probes: int = 1,
                 restart_backoff_s: float = 0.02,
                 restart_backoff_max_s: float = 1.0,
                 max_restarts: int = 0, **batcher_kwargs):
        self.predict_fn = predict_fn
        self.name = str(name)
        self._kw = dict(batcher_kwargs)
        self.breaker = breaker or CircuitBreaker(
            name=name, failure_threshold=failure_threshold,
            cooldown_s=cooldown_s, half_open_probes=half_open_probes)
        self._b0 = float(restart_backoff_s)
        self._bmax = float(restart_backoff_max_s)
        self._backoff = self._b0
        self.max_restarts = int(max_restarts)    # 0 = unbounded
        self._restarts = 0
        self._crashes = 0
        self._restart_at = 0.0
        self._closed = False
        self._lock = threading.Lock()
        self._worker_fault_hook = None   # armed on every fresh worker (tests)
        self._m_restarts = obs.counter(
            "lifecycle_worker_restarts_total",
            "batcher workers restarted after a crash").labels()
        self._m_crashes = obs.counter(
            "lifecycle_worker_crashes_total",
            "batcher worker crashes observed by the supervisor").labels()
        self._mb = self._spawn()

    def _spawn(self) -> MicroBatcher:
        mb = MicroBatcher(self.predict_fn, on_crash=self._on_crash,
                          **self._kw)
        if self._worker_fault_hook is not None:
            mb._fault_hook = self._worker_fault_hook
        return mb

    def _on_crash(self, exc: BaseException) -> None:
        # runs on the dying worker thread, BEFORE the crash fails any future
        # (batcher._crash ordering) — so a caller that sees WorkerCrashed and
        # immediately resubmits finds the breaker already informed
        with self._lock:
            self._crashes += 1
            self._restart_at = time.monotonic() + self._backoff
            self._backoff = min(self._backoff * 2.0, self._bmax)
        self._m_crashes.inc()
        self.breaker.record_failure()

    def _ensure_worker(self) -> MicroBatcher:
        with self._lock:
            if self._closed:
                raise RuntimeError("supervised batcher is closed")
            mb = self._mb
            if mb._crashed is None and not mb._closed:
                return mb
            if self.max_restarts and self._restarts >= self.max_restarts:
                raise WorkerCrashed(
                    f"supervised batcher {self.name!r}: restart budget "
                    f"({self.max_restarts}) exhausted")
            delay = self._restart_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)       # bounded by restart_backoff_max_s
        with self._lock:
            if self._closed:
                raise RuntimeError("supervised batcher is closed")
            mb = self._mb
            if mb._crashed is None and not mb._closed:
                return mb           # another submitter restarted meanwhile
            self._mb = mb = self._spawn()
            self._restarts += 1
        self._m_restarts.inc()
        return mb

    def submit(self, x_row, *, deadline_us: int | None = None):
        """Breaker-gated enqueue; returns a Future.  Raises ``CircuitOpen``
        fast while the breaker is open; a submit racing a crash retries once
        on a freshly restarted worker."""
        self.breaker.admit()
        try:
            try:
                fut = self._ensure_worker().submit(x_row,
                                                   deadline_us=deadline_us)
            except WorkerCrashed:
                fut = self._ensure_worker().submit(x_row,
                                                   deadline_us=deadline_us)
        except BaseException:
            # the admit may have consumed a half-open probe slot — a submit
            # that never produced a future must not wedge the breaker
            self.breaker.record_neutral()
            raise
        fut.add_done_callback(self._settle)
        return fut

    def _settle(self, fut) -> None:
        e = fut.exception()
        if e is None:
            with self._lock:
                self._backoff = self._b0    # healthy again: backoff resets
            self.breaker.record_success()
        elif isinstance(e, WorkerCrashed):
            pass    # the crash itself was recorded in _on_crash
        elif isinstance(e, (Overloaded, DeadlineExceeded, InvalidRequest)):
            self.breaker.record_neutral()   # load/client, not model sickness
        else:
            self.breaker.record_failure()   # model error (batch-wide)

    def predict(self, x_row, *, timeout: float | None = None,
                deadline_us: int | None = None):
        return self.submit(x_row, deadline_us=deadline_us).result(timeout)

    def close(self, timeout: float | None = None) -> None:
        with self._lock:
            self._closed = True
            mb = self._mb
        mb.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        """Current worker's stats plus supervision state.  Counters reset
        across a restart (they are the CURRENT worker's); the supervisor's
        own ``crashes``/``restarts`` are cumulative."""
        with self._lock:
            mb = self._mb
            snap = {"crashes": self._crashes, "restarts": self._restarts,
                    "restart_backoff_s": self._backoff}
        out = mb.stats()
        out.update(snap)
        out["breaker"] = self.breaker.stats()
        return out


# ---------------------------------------------------------------------------
# serving runtime: watch -> canary -> swap -> probation -> rollback
# ---------------------------------------------------------------------------

class LifecycleConfig(NamedTuple):
    """Knobs for the self-healing runtime; all thresholds deterministic so
    chaos tests pin exact behavior."""

    poll_interval_s: float = 0.5       # watcher cadence (start())
    canary_enabled: bool = True        # False: swap without validation
    canary_tol: float | None = None    # None -> the artifact's recorded tol
    require_golden: bool = False       # reject candidates with no golden set
    retain: int = 2                    # previous versions kept for rollback
    probation_s: float = 5.0           # post-swap health watch (0 = off)
    probation_min_requests: int = 20   # error-rate needs a denominator
    probation_max_error_rate: float = 0.1
    load_retries: int = 2              # transient-read retries per reload
    load_retry_backoff_s: float = 0.05
    warm_sizes: tuple[int, ...] | None = None  # buckets to capture
                                               # (None = all up to max_batch)


class _Probation(NamedTuple):
    until: float          # monotonic deadline of the watch window
    req0: int             # runtime counters at swap time
    err0: int
    nonfinite0: int


class ServingRuntime:
    """Version-watching, canary-validating, self-rolling-back serving tier.

    Owns one ``Predictor`` on ``device`` (None: the card), or a
    ``ShardedPredictor`` when ``mesh_shape`` is given (built on the
    initialised process group; this runtime then runs on rank 0 while the
    other ranks run ``serve_forever``), and hosts every live version inside
    it under artifact id ``v<N>`` — the active version is one tuple
    attribute, so ``predict`` resolves it in a single atomic read and a
    swap/rollback can never hand a request a mix of versions.
    ``poll_once`` is the deterministic unit the tests drive; ``start()``
    runs it on a daemon thread every ``poll_interval_s``.
    """

    def __init__(self, root: str, *, predictor=None,
                 mesh_shape: tuple[int, int] | None = None,
                 device=None, max_batch: int = DEFAULT_MAX_BATCH,
                 cache_entries: int = 0,
                 config: LifecycleConfig = LifecycleConfig(),
                 name: str = "default"):
        self.root = str(root)
        self.config = config
        self.name = str(name)
        if predictor is not None:
            self.predictor = predictor
        elif mesh_shape is not None:
            self.predictor = ShardedPredictor(
                mesh_shape=mesh_shape, device=device, max_batch=max_batch,
                cache_entries=cache_entries)
        else:
            self.predictor = Predictor(device=device, max_batch=max_batch,
                                       cache_entries=cache_entries)
        self.sharded = isinstance(self.predictor, ShardedPredictor)
        self._lock = threading.RLock()
        self._active: tuple[int, str] | None = None   # (version, artifact id)
        self._history: list[tuple[int, str]] = []     # oldest .. newest
        self._rejected: dict[int, str] = {}           # version -> reason
        self._probation: _Probation | None = None
        self._n_requests = 0
        self._n_model_errors = 0       # errors that indict the MODEL
        self._n_nonfinite = 0
        self._last_canary: dict | None = None
        self._canary_hook = None       # tests (faults.canary_poison)
        self._batcher: SupervisedBatcher | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # families + hot children bound once; every family is created here so
        # the series EXIST (at 0) from runtime construction — an alerting
        # rule must distinguish "no rollbacks yet" from "no runtime"
        self._m_reloads = obs.counter(
            "lifecycle_reloads_total",
            "reload attempts by outcome", labels=("result",))
        self._m_canary = obs.counter(
            "lifecycle_canary_total",
            "canary validations by verdict", labels=("verdict",))
        self._m_swaps = obs.counter(
            "lifecycle_swaps_total", "versions atomically swapped live").labels()
        self._m_rollbacks = obs.counter(
            "lifecycle_rollbacks_total",
            "instant rollbacks to a retained version").labels()
        self._m_rollback_exhausted = obs.counter(
            "lifecycle_rollback_exhausted_total",
            "rollbacks requested with no retained version left").labels()
        self._m_probation = obs.counter(
            "lifecycle_probation_total",
            "probation windows by outcome", labels=("outcome",))
        self._m_nonfinite = obs.counter(
            "lifecycle_nonfinite_predictions_total",
            "served predictions containing non-finite values").labels()
        self._g_active = obs.gauge(
            "lifecycle_active_version", "currently serving version",
            labels=("model",)).labels(self.name)
        self._g_retained = obs.gauge(
            "lifecycle_versions_retained",
            "previous versions retained for rollback",
            labels=("model",)).labels(self.name)
        self._g_active.set(0)
        self._g_retained.set(0)

    # -- serving ------------------------------------------------------------

    @property
    def active_version(self) -> int | None:
        act = self._active
        return act[0] if act is not None else None

    def predict(self, x, *, use_cache: bool = True, validate: bool = True):
        """Serve against the ACTIVE version.  The version resolves in one
        atomic read — a concurrent swap/rollback gives this request exactly
        the old or the new version, never a mix.  Outcomes feed the
        probation health check (model errors and non-finite predictions
        count against the freshly swapped version; client errors and load
        shedding do not)."""
        act = self._active
        if act is None:
            raise ServingError(
                f"no published version active under {self.root}")
        try:
            out = self.predictor.predict(x, artifact_id=act[1],
                                         use_cache=use_cache,
                                         validate=validate)
        except (InvalidRequest, Overloaded, DeadlineExceeded):
            raise
        except BaseException:
            with self._lock:
                self._n_requests += 1
                self._n_model_errors += 1
            self._maybe_autoroll()
            raise
        finite = bool(np.isfinite(out).all())
        with self._lock:
            self._n_requests += 1
            if not finite:
                self._n_nonfinite += 1
        if not finite:
            self._m_nonfinite.inc()
            self._maybe_autoroll()
        elif self._probation is not None:
            self._maybe_autoroll()
        return out

    def make_batcher(self, **kwargs) -> SupervisedBatcher:
        """A ``SupervisedBatcher`` fronting this runtime's ``predict`` (one
        breaker named after the runtime); attached for ``health()``."""
        sup = SupervisedBatcher(lambda xb: self.predict(xb), name=self.name,
                                **kwargs)
        self.predictor.attach_batcher(sup)
        self._batcher = sup
        return sup

    # -- watcher ------------------------------------------------------------

    def poll_once(self) -> dict:
        """One watcher tick: discover -> load -> warm -> canary -> swap.
        Returns an action report (``action`` in none / load_error /
        load_rejected / canary_reject / swap).  Also expires/trips the
        probation window, so a thread-less runtime still self-heals as long
        as something polls."""
        self._maybe_autoroll()
        with self._lock:
            active_version = self._active[0] if self._active else 0
            rejected = set(self._rejected)
        cands = [(v, p) for v, p in
                 discover_versions(self.root, sharded=self.sharded)
                 if v > active_version and v not in rejected]
        if not cands:
            return {"action": "none", "active": self.active_version}
        version, path = cands[-1]
        aid = f"v{version}"
        cfg = self.config
        try:
            if self.sharded:
                # every rank reads its own piece; a failure on any rank
                # raises here
                self.predictor.load(path, artifact_id=aid,
                                    retries=cfg.load_retries,
                                    retry_backoff_s=cfg.load_retry_backoff_s)
                golden = self.predictor._hosted(aid).manifest.get("golden")
            else:
                loaded = load_artifact(
                    path, device=self.predictor.device, artifact_id=aid,
                    retries=cfg.load_retries,
                    retry_backoff_s=cfg.load_retry_backoff_s)
                golden = loaded.meta.get("golden")
                self.predictor.add_model(loaded)
        except (ValueError, KeyError) as e:
            # structural: re-reading cannot fix it — quarantine the version
            with self._lock:
                self._rejected[version] = f"load: {e!r}"
            self._m_reloads.labels("load_rejected").inc()
            return {"action": "load_rejected", "version": version,
                    "error": repr(e)}
        except Exception as e:
            # transient (a publisher may still be writing): retry next tick
            self._m_reloads.labels("load_error").inc()
            return {"action": "load_error", "version": version,
                    "error": repr(e)}
        # candidate warms BEFORE it takes traffic: the swap itself then
        # captures nothing (pinned by the selftest's capture counts)
        self.predictor.warmup(artifact_id=aid, sizes=cfg.warm_sizes)
        verdict, detail = self._canary(aid, golden)
        self._m_canary.labels(verdict).inc()
        with self._lock:
            self._last_canary = {"version": version, "verdict": verdict,
                                 **detail}
        if verdict == "reject":
            with self._lock:
                self._rejected[version] = f"canary: {detail}"
            self.predictor.unload(aid)
            self._m_reloads.labels("canary_reject").inc()
            return {"action": "canary_reject", "version": version, **detail}
        self._swap(version, aid)
        self._m_reloads.labels("swap").inc()
        return {"action": "swap", "version": version, "canary": verdict,
                **detail}

    def _canary(self, aid: str, golden: dict | None) -> tuple[str, dict]:
        """Validate a loaded candidate against its recorded golden set.
        Verdicts: pass / absent (no golden set recorded) / reject."""
        cfg = self.config
        if not cfg.canary_enabled:
            return "absent", {"reason": "canary disabled"}
        if not golden:
            if cfg.require_golden:
                return "reject", {"reason": "no golden queries recorded and "
                                            "require_golden is set"}
            return "absent", {"reason": "no golden queries recorded"}
        try:
            x = np.asarray(golden["x"], np.float32)
            want = np.asarray(golden["y"], np.float32)
            tol = float(cfg.canary_tol if cfg.canary_tol is not None
                        else golden.get("tol", 1e-4))
            got = self.predictor.predict(x, artifact_id=aid, use_cache=False)
            hook = self._canary_hook
            if hook is not None:
                got = hook(np.array(got))
            got = np.asarray(got, np.float32)
        except Exception as e:
            return "reject", {"reason": f"canary predict failed: {e!r}"}
        if got.shape != want.shape:
            return "reject", {"reason": f"canary shape {got.shape} != "
                                        f"recorded {want.shape}"}
        if not np.isfinite(got).all():
            return "reject", {"reason": "non-finite canary predictions"}
        err = float(np.max(np.abs(got - want))) if want.size else 0.0
        if err > tol:
            return "reject", {"reason": f"canary disagreement {err:.3e} > "
                                        f"tol {tol:.1e}",
                              "max_abs_err": err}
        return "pass", {"max_abs_err": err}

    def _swap(self, version: int, aid: str) -> None:
        cfg = self.config
        evicted = []
        with self._lock:
            prev = self._active
            self._active = (version, aid)   # the atomic flip
            if prev is not None:
                self._history.append(prev)
            while len(self._history) > max(int(cfg.retain), 0):
                evicted.append(self._history.pop(0))
            if cfg.probation_s > 0 and prev is not None:
                self._probation = _Probation(
                    until=time.monotonic() + cfg.probation_s,
                    req0=self._n_requests, err0=self._n_model_errors,
                    nonfinite0=self._n_nonfinite)
            self._g_active.set(version)
            self._g_retained.set(len(self._history))
        self._m_swaps.inc()
        for _, old_aid in evicted:
            self.predictor.unload(old_aid)

    # -- rollback -----------------------------------------------------------

    def rollback(self, reason: str = "manual") -> bool:
        """Instant flip back to the most recently retained version; the
        rolled-away version is quarantined (never re-adopted by the
        watcher).  Returns False — and counts it — when nothing is retained."""
        with self._lock:
            return self._rollback_locked(reason)

    def _rollback_locked(self, reason: str) -> bool:
        if not self._history:
            self._m_rollback_exhausted.inc()
            return False
        bad = self._active
        self._active = self._history.pop()
        self._probation = None
        self._g_active.set(self._active[0])
        self._g_retained.set(len(self._history))
        self._m_rollbacks.inc()
        if bad is not None:
            self._rejected[bad[0]] = reason
            self.predictor.unload(bad[1])
        return True

    def _maybe_autoroll(self) -> None:
        cfg = self.config
        with self._lock:
            p = self._probation
            if p is None:
                return
            req = self._n_requests - p.req0
            err = self._n_model_errors - p.err0
            nonf = self._n_nonfinite - p.nonfinite0
            trip = nonf > 0 or (
                req >= cfg.probation_min_requests
                and err / max(req, 1) > cfg.probation_max_error_rate)
            if trip:
                self._probation = None
                self._m_probation.labels("rolled_back").inc()
                self._rollback_locked(
                    f"health regression within probation: {err}/{req} model "
                    f"errors, {nonf} non-finite predictions")
            elif time.monotonic() > p.until:
                self._probation = None
                self._m_probation.labels("passed").inc()

    # -- background watcher -------------------------------------------------

    def start(self, interval_s: float | None = None) -> None:
        """Poll on a daemon thread every ``interval_s`` (default from the
        config).  The watcher never dies: a poll raising (disk flake,
        publisher race) is counted and the next tick runs."""
        if self._thread is not None:
            return
        iv = float(interval_s if interval_s is not None
                   else self.config.poll_interval_s)
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(iv):
                try:
                    self.poll_once()
                except Exception:
                    self._m_reloads.labels("load_error").inc()

        self._thread = threading.Thread(target=loop,
                                        name="lifecycle-watcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- delegation + health ------------------------------------------------

    def warmup(self, *, sizes=None) -> int:
        act = self._require_active()
        return self.predictor.warmup(artifact_id=act[1],
                                     sizes=sizes or self.config.warm_sizes)

    def compile_count(self) -> int:
        return self.predictor.compile_count(
            artifact_id=self._require_active()[1])

    def cache_stats(self) -> dict | None:
        return self.predictor.cache_stats(
            artifact_id=self._require_active()[1])

    def attach_batcher(self, batcher) -> None:
        self.predictor.attach_batcher(batcher)

    def _require_active(self) -> tuple[int, str]:
        act = self._active
        if act is None:
            raise ServingError(
                f"no published version active under {self.root}")
        return act

    def _hosted(self, aid=None):
        # krr_serve's driver peeks at the hosted model for its dimensions
        return self.predictor._hosted(aid or self._require_active()[1])

    def health(self) -> dict:
        """Lifecycle view for ``/healthz``: active/retained/rejected
        versions, probation and last canary verdict, runtime counters, the
        wrapped predictor's own health, and — when a supervised batcher is
        attached — its breaker and restart state."""
        with self._lock:
            snap = {
                "active_version": self.active_version,
                "retained_versions": [v for v, _ in self._history],
                "rejected_versions": sorted(self._rejected),
                "probation": self._probation is not None,
                "last_canary": self._last_canary,
                "requests": self._n_requests,
                "model_errors": self._n_model_errors,
                "nonfinite": self._n_nonfinite,
            }
        snap["predictor"] = self.predictor.health()
        batcher = self._batcher
        if batcher is not None:
            snap["breaker"] = batcher.breaker.stats()
            snap["worker"] = {"crashes": batcher.stats()["crashes"],
                              "restarts": batcher.stats()["restarts"]}
        snap["ok"] = bool(snap["active_version"] is not None
                          and snap["predictor"]["ok"])
        return snap
