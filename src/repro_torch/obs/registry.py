"""Low-overhead metrics registry: counters, gauges, fixed-bucket histograms.

One process-global ``REGISTRY`` (module-level helpers ``counter`` /
``gauge`` / ``histogram`` create-or-fetch families on it) plus
instantiable ``MetricsRegistry`` objects for tests that need isolation.

Design constraints (DESIGN.md §11):

* **Hot-path cost is one lock + one float op.**  Every metric child owns a
  plain ``threading.Lock``; ``inc``/``set``/``observe`` are a handful of
  bytecodes under it — ~1us on this container, against a ~400us warm serving
  call (the metrics-on/off p50 ratio is test-pinned <= 1.05x).
* **Thread-safe by construction.**  Serving records from the batcher worker
  thread, client threads, and the driver simultaneously; family creation
  and child creation are locked on the registry, recording on the child.
* **Two export formats from one store.**  ``render()`` emits the
  Prometheus text exposition (``# HELP``/``# TYPE`` + one line per sample,
  histograms as cumulative ``_bucket``/``_sum``/``_count``) for the live
  ``/metrics`` endpoint; ``snapshot()``/``write_jsonl()`` emit the same
  state as one JSON document per call for headless runs and CI artifacts.
* **Global kill switch.**  ``set_enabled(False)`` turns every recording
  call into an immediate return (one module-global load + branch) — the
  overhead-pin test measures exactly this toggle.

Metric naming follows Prometheus conventions: ``<subsystem>_<what>_<unit>``,
counters end in ``_total``, latency histograms in ``_us`` (microseconds —
the natural unit at serving scale).
"""
from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from collections import deque

# global recording switch — checked first thing in every record call so the
# disabled path costs one global load + branch (see set_enabled)
_ENABLED = True


def set_enabled(flag: bool) -> bool:
    """Enable/disable ALL metric recording process-wide; returns the
    previous value (so callers can restore)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


def enabled() -> bool:
    return _ENABLED


# default latency buckets (microseconds): 10us .. 10s, roughly 1-2-5 per
# decade — covers cache hits (~10us) through cold compiles (~10^7 us)
LATENCY_BUCKETS_US = (
    10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2.5e5, 5e5, 1e6, 1e7,
)

# generic small-count buckets (batch sizes, iteration counts)
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0)


class Counter:
    """Monotonically increasing float."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not _ENABLED:
            return
        if v < 0:
            raise ValueError(f"counters only go up, got inc({v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: ``set``/``inc``/``dec``, or a pull-time callback
    (``set_fn``) for values that live elsewhere (cache sizes, queue depths)
    and should be read only when someone actually scrapes."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def set_fn(self, fn) -> None:
        """Register a zero-arg callable evaluated at collection time (its
        result replaces the stored value; exceptions degrade to the last
        stored value rather than failing the scrape)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            if self._fn is not None:
                try:
                    self._value = float(self._fn())
                except Exception:
                    pass
            return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum + count.

    ``buckets`` are upper bounds (ascending); an implicit +Inf bucket
    catches the tail.  ``observe`` is one bisect + three adds under the
    child lock — no allocation.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count", "_pending")

    # pending-buffer backpressure: past this many unfolded values, the
    # recording thread folds inline instead of deferring further
    PENDING_CAP = 65536

    def __init__(self, buckets=LATENCY_BUCKETS_US):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be ascending and non-empty: {b}")
        self._lock = threading.Lock()
        self.buckets = b
        self._counts = [0] * (len(b) + 1)      # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._pending = deque()                # observe_many: fold-on-read

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values) -> None:
        """Record a whole batch of values at C speed: one ``deque.extend``,
        with the bucketing deferred to the next read (``state``/``count``/
        ``sum``, i.e. a scrape or a test assert).  The serving flush path
        observes one queue-wait per coalesced row, and per-row bucketing
        there — even batched under one lock — measurably moves the
        metrics-on p50; extend+fold-on-read keeps exact histograms while the
        recording thread pays ~2us for 64 rows.  ``PENDING_CAP`` bounds the
        unfolded backlog (a recorder that outruns every scraper folds
        inline)."""
        if not _ENABLED or not len(values):
            return
        self._pending.extend(values)
        if len(self._pending) > self.PENDING_CAP:
            self._fold()

    def _fold(self) -> None:
        """Drain the pending buffer into the bucket counts.  Concurrent
        ``extend``s during the drain simply land in the next fold —
        ``deque`` append/popleft are individually atomic under CPython."""
        p = self._pending
        if not p:
            return
        b = self.buckets
        with self._lock:
            counts = self._counts
            s = 0.0
            n = 0
            while True:
                try:
                    v = p.popleft()
                except IndexError:
                    break
                counts[bisect_left(b, v)] += 1
                s += v
                n += 1
            self._sum += s
            self._count += n

    @property
    def count(self) -> int:
        self._fold()
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        self._fold()
        with self._lock:
            return self._sum

    def state(self):
        """(cumulative bucket counts incl. +Inf, sum, count) — one lock
        after folding any deferred ``observe_many`` values."""
        self._fold()
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return cum, self._sum, self._count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric + its labeled children.  ``labels(v1, v2, ...)``
    creates/fetches the child for those label VALUES (label names are fixed
    per family); a label-less family has a single default child reachable by
    calling the record methods on the family itself."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: tuple[str, ...] = (), **kwargs):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**kwargs)

    def labels(self, *values) -> Counter | Gauge | Histogram:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {values!r}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _KINDS[self.kind](
                    **self._kwargs))
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             f"call .labels(...) first")
        return self._children[()]

    # label-less convenience: family acts as its single child
    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def set_fn(self, fn) -> None:
        self._default().set_fn(fn)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def observe_many(self, values) -> None:
        self._default().observe_many(values)

    @property
    def value(self):
        return self._default().value

    def state(self):
        return self._default().state()

    def children(self):
        with self._lock:
            return list(self._children.items())


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers render bare."""
    return str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)


def _labelstr(names, values) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


class MetricsRegistry:
    """Name -> Family store with the two exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _family(self, name: str, kind: str, help: str,
                labels: tuple[str, ...], **kwargs) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, kind, help, labels, **kwargs)
                    self._families[name] = fam
        if fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}, requested {kind}/{tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets=LATENCY_BUCKETS_US) -> Family:
        return self._family(name, "histogram", help, labels, buckets=buckets)

    def reset(self) -> None:
        """Drop every family (tests; the live endpoint never calls this)."""
        with self._lock:
            self._families.clear()

    def _sorted_families(self):
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    # -- Prometheus text exposition -----------------------------------------

    def render(self) -> str:
        """Text exposition (version 0.0.4): the /metrics payload."""
        lines: list[str] = []
        for fam in self._sorted_families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for lv, child in sorted(fam.children()):
                ls = _labelstr(fam.labelnames, lv)
                if fam.kind == "histogram":
                    cum, total, count = child.state()
                    uppers = [*(_fmt(b) for b in child.buckets), "+Inf"]
                    for ub, c in zip(uppers, cum):
                        sep = "," if ls else ""
                        pre = ls[:-1] + sep if ls else "{"
                        lines.append(
                            f'{fam.name}_bucket{pre}le="{ub}"}} {c}')
                    lines.append(f"{fam.name}_sum{ls} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{ls} {count}")
                else:
                    lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- JSON snapshot -------------------------------------------------------

    def snapshot(self) -> dict:
        """The registry as one JSON-able dict (same data as ``render``)."""
        out: dict = {}
        for fam in self._sorted_families():
            series = []
            for lv, child in sorted(fam.children()):
                labels = dict(zip(fam.labelnames, lv))
                if fam.kind == "histogram":
                    cum, total, count = child.state()
                    series.append({"labels": labels,
                                   "buckets": list(child.buckets),
                                   "cumulative": cum,
                                   "sum": total, "count": count})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def write_jsonl(self, path: str, extra: dict | None = None) -> dict:
        """Append ONE line — ``{"ts": ..., **extra, "metrics": snapshot}`` —
        to ``path`` (the per-run perf-trajectory format CI uploads next to
        the bench JSONs).  Returns the record."""
        record = {"ts": time.time(), **(extra or {}),
                  "metrics": self.snapshot()}
        with open(path, "a") as fh:
            fh.write(json.dumps(record) + "\n")
        return record


# the process-global registry every instrumented module records into
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Family:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: tuple[str, ...] = ()) -> Family:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: tuple[str, ...] = (),
              buckets=LATENCY_BUCKETS_US) -> Family:
    return REGISTRY.histogram(name, help, labels, buckets=buckets)
