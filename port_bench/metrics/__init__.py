"""Per-layer metrics, one reader a file (``<metric>.py``, ``read(run)``),
loaded by the harness by the metric's name in ``BENCHMARK.json``."""
