"""Micro-batching engine: coalesce single-point requests under a deadline.

State machine (one worker thread):

    IDLE     -- blocked on the queue; a request arrives -> FILLING and the
                flush deadline is armed at t_arrival + max_wait_us
    FILLING  -- drain further requests; flush when the batch hits max_batch
                or the deadline expires, whichever first
    FLUSH    -- stack the pending rows, run predict_fn once, resolve every
                request's future (or fail them all with the raised
                exception) -> IDLE

max_batch bounds tail latency under load (a full batch flushes immediately);
max_wait_us bounds it when idle (a lone request waits at most one deadline).
Each request costs its queue wait plus a 1/batch share of one warm-path call
— which is how single-point traffic gets batched-throughput economics.

``submit`` returns a ``concurrent.futures.Future``; the caller's thread never
blocks unless it asks for ``.result()``.  Stats are collected continuously
(served counts, batch-size histogram summary, latency percentiles over a
sliding window, queue depth) and read with ``stats()``.

Pure Python and numpy: a copy of the JAX package's module with the port's
errors and ``obs``.

Degraded-mode contract (DESIGN.md §9): every failure is a STRUCTURED result
on the request's future, never a hang —

* queue full (``max_queue``)      -> ``Overloaded``, failed at submit
* deadline elapsed in queue       -> ``DeadlineExceeded``, failed at flush
* predict_fn raised               -> that exception, batch-wide
* worker thread died              -> ``WorkerCrashed`` on every in-flight and
                                     queued future; later submits fail fast
"""
from __future__ import annotations

import collections
import math
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from .. import obs
from ..errors import DeadlineExceeded, Overloaded, WorkerCrashed


class _Request:
    __slots__ = ("x", "future", "t_submit", "deadline")

    def __init__(self, x: np.ndarray, deadline: float | None = None):
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # absolute perf_counter time after which serving is pointless
        self.deadline = deadline


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence: the
    ceil(q/100 * n)-th smallest value (so q=99 over 100 samples is the
    99th-smallest, not the maximum)."""
    if not sorted_vals:
        return float("nan")
    n = len(sorted_vals)
    rank = max(0, min(n - 1, math.ceil(q / 100.0 * n) - 1))
    return float(sorted_vals[rank])


class MicroBatcher:
    """Thread-safe request queue in front of a batch predict function.

    ``predict_fn`` maps a (b, d) float32 batch to per-row predictions; it is
    only ever called from the single worker thread, so it needs no locking of
    its own (the Predictor's warm path and cache are thread-safe anyway).
    """

    def __init__(self, predict_fn, *, max_batch: int = 64,
                 max_wait_us: int = 2000, latency_window: int = 4096,
                 dim: int | None = None, max_queue: int = 0,
                 deadline_us: int | None = None, on_crash=None):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 = unbounded)")
        self.predict_fn = predict_fn
        self.max_batch = int(max_batch)
        # load shedding: submits past this queue depth fail with Overloaded
        # instead of growing an unbounded backlog (0 disables)
        self.max_queue = int(max_queue)
        # default per-request deadline budget; a request still queued when
        # its budget elapses fails with DeadlineExceeded at flush time
        # (before predict — an expired request never costs model work)
        self.deadline_s = (None if deadline_us is None
                           else max(int(deadline_us), 0) * 1e-6)
        # one batcher fronts one model, so every row must share one d —
        # checked at submit() so a malformed request is rejected at ITS
        # call site instead of blowing up np.stack in _flush and failing
        # every innocent request coalesced into the same batch.  None =
        # locked in from the first accepted request.
        self._dim = int(dim) if dim is not None else None
        self.max_wait_s = max(int(max_wait_us), 0) * 1e-6
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._latencies = collections.deque(maxlen=latency_window)
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_served = 0
        self._n_batches = 0
        self._batch_rows = 0
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._n_shed = 0
        self._n_expired = 0
        self._queue_hwm = 0
        self._last_error: str | None = None
        # registry children resolved once (name->family lookups off the
        # submit/flush paths); instance stats() stays per-batcher exact,
        # the global registry aggregates across batchers
        self._m_queue_wait = obs.histogram(
            "serve_queue_wait_us", "request wait from submit to flush").labels()
        self._m_predict = obs.histogram(
            "serve_batch_predict_us", "predict_fn wall time per batch").labels()
        self._m_batch_size = obs.histogram(
            "serve_batch_size", "rows coalesced per flushed batch",
            buckets=obs.COUNT_BUCKETS).labels()
        self._m_requests = obs.counter(
            "serve_batcher_requests_total", "requests submitted").labels()
        self._m_served = obs.counter(
            "serve_batcher_served_total", "requests served successfully").labels()
        self._m_batches = obs.counter(
            "serve_batcher_batches_total", "batches flushed").labels()
        self._m_shed = obs.counter(
            "serve_batcher_shed_total", "requests shed at max_queue").labels()
        self._m_expired = obs.counter(
            "serve_batcher_deadline_expired_total",
            "requests expired in queue before predict").labels()
        self._m_hwm = obs.gauge(
            "serve_queue_depth_hwm", "high-water mark of the request queue").labels()
        # flat pre-bound timer: one per flushed batch on the worker thread
        self._t_batch = obs.timer("serve.batch_predict",
                                  to_histogram=self._m_predict)
        self._closed = False
        self._crashed: BaseException | None = None
        self._inflight: list[_Request] | None = None
        self._fault_hook = None         # test injection (faults.crash_worker)
        # supervision hook (lifecycle.SupervisedBatcher): called with the
        # fatal exception AFTER the crash state is set but BEFORE any future
        # fails, so by the time a caller observes a WorkerCrashed result the
        # supervisor has already recorded the crash (breaker trip, restart
        # scheduling) — no window where a fast retry misses the breaker
        self._on_crash = on_crash
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, x_row, *, deadline_us: int | None = None) -> Future:
        """Enqueue one d-dimensional point; resolves to its prediction.

        ``deadline_us`` overrides the batcher's default budget for this
        request.  A shed/expired/crashed request still gets a future — one
        already failed with the structured error."""
        req = _Request(np.asarray(x_row, np.float32).reshape(-1))
        budget = (deadline_us * 1e-6 if deadline_us is not None
                  else self.deadline_s)
        if budget is not None:
            req.deadline = req.t_submit + budget
        # the closed-check and the enqueue are one atomic step: close() flips
        # the flag and enqueues its sentinel under the same lock, so either
        # this request lands BEFORE the sentinel (and is served/drained) or
        # the submit raises — a request can never slip in behind the drain
        # and leave its future forever unresolved
        with self._lock:
            if self._crashed is not None:
                raise WorkerCrashed(
                    f"batcher worker died: {self._crashed!r}")
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._dim is None:
                self._dim = req.x.shape[0]
            elif req.x.shape[0] != self._dim:
                raise ValueError(f"request has {req.x.shape[0]} features, "
                                 f"batcher serves d={self._dim}")
            self._n_requests += 1
            if self.max_queue and self._queue.qsize() >= self.max_queue:
                self._n_shed += 1
                depth = self._queue.qsize()
                self._m_requests.inc()
                self._m_shed.inc()
                req.future.set_exception(Overloaded(
                    f"request shed: queue depth {depth} >= "
                    f"max_queue {self.max_queue}", queue_depth=depth))
                return req.future
            self._queue.put(req)
            depth = self._queue.qsize()
            if depth > self._queue_hwm:
                self._queue_hwm = depth
                self._m_hwm.set(depth)
        # accepted requests hit serve_batcher_requests_total at FLUSH time
        # (one inc per batch, not per submit) — only sheds inc here
        return req.future

    def predict(self, x_row, *, timeout: float | None = None,
                deadline_us: int | None = None):
        """Synchronous submit + wait.  ``timeout`` bounds the caller's wait
        (``concurrent.futures.TimeoutError``); structured serving errors
        (Overloaded, DeadlineExceeded, WorkerCrashed) re-raise here."""
        return self.submit(x_row, deadline_us=deadline_us).result(timeout)

    def close(self, timeout: float | None = None) -> None:
        """Stop the worker.  Everything already submitted is served first:
        submit() and close() serialize on one lock, so every accepted
        request sits FIFO-ahead of the stop sentinel and the worker flushes
        them all before it exits."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)                   # wake + stop sentinel
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side --------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                req = self._queue.get()             # IDLE
                if req is None:
                    return
                batch = [req]                       # FILLING
                deadline = time.perf_counter() + self.max_wait_s
                stop = False
                while len(batch) < self.max_batch:
                    try:
                        # anything ALREADY queued joins the batch at once —
                        # under backlog the deadline never delays (or
                        # starves) coalescing, it only bounds the wait for
                        # new arrivals
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            break
                        try:
                            nxt = self._queue.get(timeout=timeout)
                        except queue.Empty:
                            break
                    if nxt is None:
                        stop = True
                        break
                    batch.append(nxt)
                self._dispatch(batch)               # FLUSH -> IDLE
                if stop:
                    return
        except BaseException as e:
            # a genuine worker death (not a predict_fn error — _flush
            # already contains those batch-wide): fail everything, fast
            self._crash(e)

    def _dispatch(self, batch: list[_Request]) -> None:
        # _inflight is what _crash fails if anything below dies; the fault
        # hook fires OUTSIDE _flush's predict try/except on purpose — it
        # simulates the worker thread itself dying, not a model error
        self._inflight = batch
        hook = self._fault_hook
        if hook is not None:
            hook(batch)
        self._flush(batch)
        self._inflight = None

    def _crash(self, e: BaseException) -> None:
        with self._lock:
            self._crashed = e
            self._closed = True
            self._last_error = repr(e)
        if self._on_crash is not None:
            try:
                self._on_crash(e)
            except Exception:
                pass    # supervision must never mask the crash drain below
        err = WorkerCrashed(f"batcher worker died: {e!r}")
        err.__cause__ = e
        for r in self._inflight or []:
            if not r.future.done():
                r.future.set_exception(err)
        # drain everything queued behind the death; submit() checks
        # _crashed under the same lock BEFORE enqueueing, so nothing can
        # land after this drain and hang forever
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                return
            if nxt is not None and not nxt.future.done():
                nxt.future.set_exception(err)

    def _flush(self, batch: list[_Request]) -> None:
        now = time.perf_counter()
        live = []
        expired = 0
        waits = []
        for r in batch:
            waits.append((now - r.t_submit) * 1e6)
            if r.deadline is not None and now > r.deadline:
                waited = now - r.t_submit
                r.future.set_exception(DeadlineExceeded(
                    f"deadline elapsed after {waited * 1e6:.0f}us in queue",
                    waited_s=waited))
                expired += 1
            else:
                live.append(r)
        if live:
            try:
                with self._t_batch():
                    out = self.predict_fn(np.stack([r.x for r in live]))
            except BaseException as e:
                with self._lock:
                    self._last_error = repr(e)
                for r in live:
                    r.future.set_exception(e)
                self._record_flush(waits, expired, served=None)
                return
            now = time.perf_counter()
            with self._lock:
                if self._t_first is None:
                    self._t_first = live[0].t_submit
                self._t_last = now
                self._n_batches += 1
                self._batch_rows += len(live)
                self._n_served += len(live)
                for r in live:
                    self._latencies.append(now - r.t_submit)
            for r, row in zip(live, np.asarray(out)):
                r.future.set_result(row)
        # registry recording runs AFTER every future is resolved: metrics
        # must never sit on the response critical path (they only eat
        # worker headroom between batches)
        self._record_flush(waits, expired, served=len(live) if live else None)

    def _record_flush(self, waits, expired: int, served: int | None) -> None:
        self._m_queue_wait.observe_many(waits)   # one lock for the batch
        self._m_requests.inc(len(waits))         # accepted-request count,
        if expired:                              # batched off the submit path
            self._m_expired.inc(expired)
            with self._lock:
                self._n_expired += expired
        if served is not None:
            self._m_batch_size.observe(served)
            self._m_batches.inc()
            self._m_served.inc(served)

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Snapshot: served/batch counts, mean coalesced batch size, sliding-
        window latency percentiles (us), achieved QPS, live queue depth and
        its high-water mark, plus the degraded-mode counters (shed,
        deadline-expired, crash state)."""
        with self._lock:
            lat = sorted(self._latencies)
            span = (self._t_last - self._t_first) \
                if self._t_first is not None and self._t_last is not None \
                else 0.0
            return {
                "requests": self._n_requests,
                "served": self._n_served,
                "batches": self._n_batches,
                "mean_batch": (self._batch_rows / self._n_batches
                               if self._n_batches else 0.0),
                "queue_depth": self._queue.qsize(),
                "queue_depth_hwm": self._queue_hwm,
                "p50_us": percentile(lat, 50) * 1e6,
                "p99_us": percentile(lat, 99) * 1e6,
                "qps": self._n_served / span if span > 0 else 0.0,
                "shed": self._n_shed,
                "shed_rate": (self._n_shed / self._n_requests
                              if self._n_requests else 0.0),
                "deadline_expired": self._n_expired,
                "crashed": self._crashed is not None,
                "last_error": self._last_error,
            }
