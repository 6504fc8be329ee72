"""Span-based tracing: nested timed regions with attributes.

``span("pcg.iter")`` is a context manager that times the enclosed block on
the host clock, nests (thread-local stack; the name you give is the name
you query — nesting is carried via ``parent``/``depth`` and attribute
inheritance rather than path concatenation, so hot-path names stay stable
dict keys), carries attributes (child spans see their ancestors' attrs merged under
theirs), and optionally opens a ``torch.profiler.record_function`` region with the
same name so host spans line up with device timelines in the Chrome
traces captured via ``start_trace``/``stop_trace``.

Every finished span appends its duration (microseconds) to a bounded
per-name sample buffer — that buffer is the single timing source of truth
the benchmarks read (``span_samples_us``/``span_stats``) instead of
keeping their own ``perf_counter`` pairs — and optionally feeds a registry
histogram (``to_histogram=``).

Two weights of timed region share the sample buffers: ``span`` (nesting,
attrs, per-call name resolution — for macro regions like a solve or a
benchmark iteration) and the pre-bound ``timer`` (flat, buffer + histogram
resolved once at construction — for per-request serving sites, where the
metrics-on/off p50 pin holds the budget to <=5%).  With tracing disabled
(``set_tracing(False)``) both return a shared no-op singleton and the cost
is one global load + branch.
"""
from __future__ import annotations

import threading
from collections import deque
from time import perf_counter

from . import registry as _registry

_TRACING = True          # span timing + sample collection
_ANNOTATIONS = False  # also open torch.profiler.record_function regions

_SAMPLE_CAP = 4096  # per-name bounded buffer; old samples fall off the left

_local = threading.local()

_samples_lock = threading.Lock()
_samples: dict[str, deque] = {}


def set_tracing(flag: bool) -> bool:
    """Master switch for span timing; returns the previous value."""
    global _TRACING
    prev = _TRACING
    _TRACING = bool(flag)
    return prev


def set_annotations(flag: bool) -> bool:
    """Also wrap each span in ``torch.profiler.record_function`` (off by
    default: it costs a C++ call per span and only matters while a
    profiler trace is being captured).  Returns the previous value."""
    global _ANNOTATIONS
    prev = _ANNOTATIONS
    _ANNOTATIONS = bool(flag)
    return prev


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_span():
    """The innermost open span on this thread, or None."""
    st = getattr(_local, "stack", None)
    return st[-1] if st else None


def _record_sample(name: str, us: float) -> None:
    buf = _samples.get(name)
    if buf is None:
        with _samples_lock:
            buf = _samples.setdefault(name, deque(maxlen=_SAMPLE_CAP))
    buf.append(us)


def span_samples_us(name: str) -> list[float]:
    """Duration samples (microseconds) recorded for ``name``, oldest
    first, up to the buffer cap."""
    buf = _samples.get(name)
    return list(buf) if buf else []


def clear_span_samples(name: str | None = None) -> None:
    """Drop collected samples for one span name (or all) — benchmarks call
    this between tiers so each tier reads only its own iterations.  Buffers
    are cleared IN PLACE, never popped: pre-bound ``timer`` sites hold a
    direct reference to their buffer."""
    with _samples_lock:
        if name is None:
            for buf in _samples.values():
                buf.clear()
        else:
            buf = _samples.get(name)
            if buf is not None:
                buf.clear()


def span_stats(name: str) -> dict:
    """{count, mean_us, p50_us, p99_us, min_us, max_us} over the current
    sample buffer (zeros when empty)."""
    xs = sorted(span_samples_us(name))
    if not xs:
        return {"count": 0, "mean_us": 0.0, "p50_us": 0.0, "p99_us": 0.0,
                "min_us": 0.0, "max_us": 0.0}

    def pct(q):
        i = min(len(xs) - 1, max(0, int(round(q / 100 * (len(xs) - 1)))))
        return xs[i]

    return {"count": len(xs), "mean_us": sum(xs) / len(xs),
            "p50_us": pct(50), "p99_us": pct(99),
            "min_us": xs[0], "max_us": xs[-1]}


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        return self

    @property
    def attrs(self):
        return {}

    duration_us = 0.0


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "parent", "depth", "_attrs", "_t0", "duration_us",
                 "_hist", "_prof_ctx", "_st")

    def __init__(self, name: str, attrs: dict | None = None, hist=None):
        self.name = name
        self.parent = None
        self.depth = 0
        self._attrs = attrs
        self._t0 = 0.0
        self.duration_us = 0.0
        self._hist = hist
        self._prof_ctx = None
        self._st = None

    @property
    def attrs(self) -> dict:
        """This span's attributes merged over its ancestors' (own keys
        win).  Computed on access — the hot path never pays for it."""
        merged: dict = {}
        chain = []
        node = self
        while node is not None:
            chain.append(node)
            node = node.parent
        for node in reversed(chain):
            if node._attrs:
                merged.update(node._attrs)
        return merged

    def set_attr(self, key: str, value) -> "Span":
        if self._attrs is None:
            self._attrs = {}
        self._attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        st = self._st = _stack()
        if st:
            self.parent = st[-1]
            self.depth = self.parent.depth + 1
        st.append(self)
        if _ANNOTATIONS:
            try:
                import torch.profiler
                self._prof_ctx = torch.profiler.record_function(self.name)
                self._prof_ctx.__enter__()
            except Exception:
                self._prof_ctx = None
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        us = (perf_counter() - self._t0) * 1e6
        self.duration_us = us
        if self._prof_ctx is not None:
            try:
                self._prof_ctx.__exit__(*exc)
            except Exception:
                pass
        st = self._st
        if st and st[-1] is self:
            st.pop()
        elif self in st:            # tolerate out-of-order exits
            st.remove(self)
        _record_sample(self.name, us)
        if self._hist is not None:
            self._hist.observe(us)
        return False


def span(name: str, attrs: dict | None = None, *, to_histogram=None):
    """Open a timed span.  ``to_histogram`` takes a registry Histogram (or
    label-less Family) that additionally receives the duration."""
    if not _TRACING:
        return _NOOP
    return Span(name, attrs, to_histogram)


class _TimedSample:
    """One flat timing region opened by a ``Timer``: records into the
    pre-bound sample buffer + histogram, participates in profiler traces
    via record_function, but skips the nesting stack and attrs entirely."""

    __slots__ = ("_name", "_buf", "_hist", "_t0", "_prof")

    def __init__(self, name, buf, hist):
        self._name = name
        self._buf = buf
        self._hist = hist
        self._t0 = 0.0
        self._prof = None

    def __enter__(self):
        if _ANNOTATIONS:
            try:
                import torch.profiler
                self._prof = torch.profiler.record_function(self._name)
                self._prof.__enter__()
            except Exception:
                self._prof = None
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        us = (perf_counter() - self._t0) * 1e6
        if self._prof is not None:
            try:
                self._prof.__exit__(*exc)
            except Exception:
                pass
        self._buf.append(us)
        if self._hist is not None:
            self._hist.observe(us)
        return False


class Timer:
    """Factory for one fixed hot call site — build once, open per call."""

    __slots__ = ("_name", "_buf", "_hist")

    def __init__(self, name, buf, hist):
        self._name = name
        self._buf = buf
        self._hist = hist

    def __call__(self):
        if not _TRACING:
            return _NOOP
        return _TimedSample(self._name, self._buf, self._hist)


def timer(name: str, *, to_histogram=None) -> Timer:
    """Pre-bound flat timer for a FIXED hot call site: resolve the sample
    buffer and histogram child once at construction, then ``with t():`` per
    call costs two ``perf_counter`` reads, one deque append, one histogram
    observe — roughly half a full ``span``.  The duration lands in the same
    per-name buffer ``span_samples_us``/``span_stats`` read, and the region
    still gets a record_function region during profiler captures; what it gives up
    is nesting (never on the thread-local stack) and attrs.  Use ``span``
    for macro regions (a solve, a benchmark iteration), ``timer`` for
    per-request serving sites."""
    with _samples_lock:
        buf = _samples.setdefault(name, deque(maxlen=_SAMPLE_CAP))
    return Timer(name, buf, to_histogram)


def annotation(name: str):
    """A named ``torch.profiler.record_function`` region ONLY while a profiler
    trace is being captured (``start_trace``); the shared no-op otherwise.

    This is the near-free sibling of ``span`` for inner hot-path regions
    that already have their duration recorded some other way (a direct
    histogram observe) and only need a name on the trace timeline —
    it allocates nothing and records nothing outside a capture."""
    if not _ANNOTATIONS:
        return _NOOP
    try:
        import torch.profiler
        return torch.profiler.record_function(name)
    except Exception:
        return _NOOP


# -- whole-program profiler traces (Chrome trace JSON) -----------------------

_trace_dir: str | None = None
_profiler = None


def start_trace(trace_dir: str) -> bool:
    """Begin a ``torch.profiler`` capture (CPU, plus CUDA when a card is
    present) that ``stop_trace`` writes to ``trace_dir/trace.json`` (open in
    Perfetto or chrome://tracing), and turn on per-span
    ``record_function`` regions so the host spans appear on the timeline.
    Returns False (and records nothing) if the profiler is unavailable."""
    global _trace_dir, _profiler
    try:
        import torch
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        prof = tp.profile(activities=acts)
        prof.__enter__()
    except Exception:
        return False
    _trace_dir, _profiler = trace_dir, prof
    set_annotations(True)
    _registry.counter(
        "trace_sessions_total", "profiler trace captures started").inc()
    return True


def stop_trace() -> str | None:
    """End the active profiler capture and write its Chrome trace; returns
    its directory (or None)."""
    global _trace_dir, _profiler
    d, prof = _trace_dir, _profiler
    _trace_dir = _profiler = None
    set_annotations(False)
    if prof is not None:
        try:
            import os
            prof.__exit__(None, None, None)
            os.makedirs(d, exist_ok=True)
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception:
            pass
    return d
