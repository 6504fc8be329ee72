"""matvec_host_us: the host's time to issue one operator matvec (the
fused matvec and its combine, or the split path), in us: the median of
the program's ``op.matvec`` timer over the traced window's fits, whose
solves run iters + 1 matvecs each (the initial residual's is one).
``.forest``: the same in ``fit.forest``."""
from port_bench.metrics.pcg_host_us import window_median


def read(run):
    return window_median(run, "op.matvec", per_fit=1)
