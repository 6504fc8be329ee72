"""pcg_wait_us: one PCG convergence test, in us: the median of the
program's ``pcg.wait`` timer (``bool(active.any())``, the iteration's one
sync: the host blocked until the device has finished the work before it)
over the traced window's iterations.  ``.forest``: the same in
``fit.forest``."""
from port_bench.metrics.pcg_host_us import window_median


def read(run):
    return window_median(run, "pcg.wait")
