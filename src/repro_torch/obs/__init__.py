"""Telemetry of the port: metrics registry and span tracing (stdlib only;
a copy of the JAX package's, with ``torch.profiler`` in place of the JAX
profiler).  Instrumented call sites do::

    from repro_torch import obs

    obs.counter("hashjoin_routing_builds_total").inc()
    with obs.span("dist.krr_step", to_histogram=obs.histogram(
            "dist_krr_step_us")):
        ...

and a process writes everything out with ``obs.REGISTRY.write_jsonl``.
The live HTTP endpoint waits for the serving slice.
"""
from .registry import (
    COUNT_BUCKETS,
    LATENCY_BUCKETS_US,
    MetricsRegistry,
    REGISTRY,
    counter,
    enabled,
    gauge,
    histogram,
    set_enabled,
)
from .tracing import (
    annotation,
    clear_span_samples,
    current_span,
    set_annotations,
    set_tracing,
    span,
    span_samples_us,
    span_stats,
    start_trace,
    stop_trace,
    timer,
)

__all__ = [
    "COUNT_BUCKETS",
    "LATENCY_BUCKETS_US",
    "MetricsRegistry",
    "REGISTRY",
    "annotation",
    "clear_span_samples",
    "counter",
    "current_span",
    "enabled",
    "gauge",
    "histogram",
    "set_annotations",
    "set_enabled",
    "set_tracing",
    "span",
    "span_samples_us",
    "span_stats",
    "start_trace",
    "stop_trace",
    "timer",
]
