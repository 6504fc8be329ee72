"""Span-based tracing: nested timed regions with attributes.

``span("pcg.iter")`` is a context manager that times the enclosed block on
the host clock, nests (thread-local stack; the name you give is the name
you query — nesting is carried via ``parent``/``depth`` and attribute
inheritance rather than path concatenation, so hot-path names stay stable
dict keys), and carries attributes (child spans see their ancestors' attrs
merged under theirs).

Whenever a ``torch.profiler`` capture is active, whoever started it (a
``torch.profiler.profile`` block, or ``start_trace``), every span and timer
also opens a profiler region of its own name (torch's function-scope
``_RecordFunctionFast``, see ``_capture``), so the host's spans share the
capture's clock with the device's kernels.  The test is torch's own flag
(``torch.autograd.profiler._is_profiler_enabled``), read without importing
torch: outside a capture it costs one flag read.

Every finished span appends its duration (microseconds) to a bounded
per-name sample buffer — that buffer is the single timing source of truth
the benchmarks read (``span_samples_us``/``span_stats``) instead of
keeping their own ``perf_counter`` pairs — and optionally feeds a registry
histogram (``to_histogram=``).

Two weights of timed region share the sample buffers: ``span`` (nesting,
attrs, per-call name resolution — for macro regions like a solve or a
benchmark iteration) and the pre-bound ``timer`` (flat, buffer + histogram
resolved once at construction — for per-request serving sites, where the
metrics-on/off p50 pin holds the budget to <=5%, and the solver's
per-iteration sites).  With tracing disabled (``set_tracing(False)``) both
return a shared no-op singleton and the cost is one global load + branch.
"""
from __future__ import annotations

import sys
import threading
from collections import deque
from time import perf_counter

from . import registry as _registry

_TRACING = True          # span timing + sample collection

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


def tracing_enabled() -> bool:
    """Whether spans and timers are timing (see ``set_tracing``)."""
    return _TRACING


# once torch is loaded: the module holding its profiler flag, and the
# region type (None until then: no capture can be active in a process that
# has not loaded torch)
_autograd_profiler = None
_region = None


def _capture():
    """The profiler region type while a ``torch.profiler`` capture is active
    in this process, whoever started it; None otherwise.

    The region is torch's function-scope ``_RecordFunctionFast`` (the one
    compiled code annotates with).  A user-scope ``record_function`` would
    also have the profiler correlate every kernel launched inside it with
    the region, which slowed the traced PCG iteration of a 500000-point fit
    by 14 % on an H100, where the function-scope region cost under 1 %; so
    there is no fallback to it, and a torch without the function-scope
    region fails here rather than moving every traced timing."""
    global _autograd_profiler, _region
    mod = _autograd_profiler
    if mod is None:
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None or not hasattr(mod, "_is_profiler_enabled"):
            return None
        _region = sys.modules["torch"]._C._profiler._RecordFunctionFast
        _autograd_profiler = mod
    return _region if mod._is_profiler_enabled else None


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
        region = _capture()
        if region is not None:
            self._prof_ctx = region(self.name)
            self._prof_ctx.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        us = (perf_counter() - self._t0) * 1e6
        self.duration_us = us
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
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
    as a function-scope region, but skips the nesting stack and attrs entirely."""

    __slots__ = ("_name", "_buf", "_hist", "_t0", "_prof")

    def __init__(self, name, buf, hist):
        self._name = name
        self._buf = buf
        self._hist = hist
        self._t0 = 0.0
        self._prof = None

    def __enter__(self):
        region = _capture()
        if region is not None:
            self._prof = region(self._name)
            self._prof.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        us = (perf_counter() - self._t0) * 1e6
        if self._prof is not None:
            self._prof.__exit__(*exc)
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
    is still a profiler region during captures; what it gives up
    is nesting (never on the thread-local stack) and attrs.  Use ``span``
    for macro regions (a solve, a benchmark iteration), ``timer`` for
    per-request serving sites."""
    with _samples_lock:
        buf = _samples.setdefault(name, deque(maxlen=_SAMPLE_CAP))
    return Timer(name, buf, to_histogram)


# -- whole-program profiler traces (Chrome trace JSON) -----------------------

_trace_dir: str | None = None
_profiler = None


def start_trace(trace_dir: str) -> bool:
    """Begin a ``torch.profiler`` capture (CPU, plus CUDA when a card is
    present) that ``stop_trace`` writes to ``trace_dir/trace.json`` (open in
    Perfetto or chrome://tracing); the host's spans appear on its timeline,
    as under any capture.  Returns False (and records nothing) if the
    profiler is unavailable."""
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
    _registry.counter(
        "trace_sessions_total", "profiler trace captures started").inc()
    return True


def stop_trace() -> str | None:
    """End the active profiler capture and write its Chrome trace; returns
    its directory (or None)."""
    global _trace_dir, _profiler
    d, prof = _trace_dir, _profiler
    _trace_dir = _profiler = None
    if prof is not None:
        try:
            import os
            prof.__exit__(None, None, None)
            os.makedirs(d, exist_ok=True)
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception:
            pass
    return d
