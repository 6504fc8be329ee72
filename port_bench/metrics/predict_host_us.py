"""predict_host_us: a predict call's host time, from its entry to its
return before the caller's sync, in us: the median of the program's
``predict`` span over its sample buffer (the traced window's newest
4096 calls)."""
from port_bench.metrics.pcg_host_us import samples_median


def read(run):
    return samples_median("predict")
