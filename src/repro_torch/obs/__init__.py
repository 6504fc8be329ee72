"""Telemetry of the port: metrics registry and span tracing (stdlib only;
a copy of the JAX package's, with ``torch.profiler`` in place of the JAX
profiler).  Instrumented call sites do::

    from repro_torch import obs

    obs.counter("hashjoin_routing_builds_total").inc()
    with obs.span("dist.krr_step", to_histogram=obs.histogram(
            "dist_krr_step_us")):
        ...

and a process writes everything out with ``obs.REGISTRY.write_jsonl``
(headless snapshot) or exposes it with ``obs.serve_metrics(port)`` (live
Prometheus text and ``/healthz``, http.py).  Under any active
``torch.profiler`` capture each span and timer is also a function-scope
profiler region of its name on the capture's timeline (tracing.py).
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
from .http import (
    MetricsServer,
    add_health_provider,
    health_document,
    remove_health_provider,
    serve_metrics,
)
from .tracing import (
    clear_span_samples,
    current_span,
    set_tracing,
    span,
    span_samples_us,
    span_stats,
    start_trace,
    stop_trace,
    timer,
    tracing_enabled,
)

__all__ = [
    "COUNT_BUCKETS",
    "LATENCY_BUCKETS_US",
    "MetricsRegistry",
    "MetricsServer",
    "REGISTRY",
    "add_health_provider",
    "clear_span_samples",
    "counter",
    "current_span",
    "enabled",
    "gauge",
    "health_document",
    "histogram",
    "remove_health_provider",
    "serve_metrics",
    "set_enabled",
    "set_tracing",
    "span",
    "span_samples_us",
    "span_stats",
    "start_trace",
    "stop_trace",
    "timer",
    "tracing_enabled",
]
