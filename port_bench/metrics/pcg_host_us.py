"""pcg_host_us: the host's time to issue one PCG iteration, in us: the
median of the program's ``pcg.issue`` timer (``step(state)``, which holds
no device sync) over the traced window's iterations.  ``.forest``: the
same in ``fit.forest``.

The helpers here are shared by the readers of the program's other spans
and timers: a fit cell's window takes the newest samples, as many as its
fits ran (the set-up's warm fit recorded the same names before them); a
predict cell's window makes more calls than the program's 4096-sample
buffer holds, so the buffer is the window's."""
from statistics import median

SPAN = "pcg.issue"


def samples_median(name: str, count: int | None = None):
    """The median of the newest ``count`` samples (all the buffer holds
    when None) of the program's span or timer ``name``, in us; None with
    none (a program without that span)."""
    from repro_torch import obs
    xs = obs.span_samples_us(name)
    if count is not None:
        xs = xs[-count:] if count > 0 else []
    return median(xs) if xs else None


def window_median(run, name: str, per_fit: int = 0):
    """``samples_median`` over a fit cell's window: sum(iters + per_fit)
    samples of its fits."""
    return samples_median(name, sum(f["iters"] + per_fit for f in run.fits))


def read(run):
    return window_median(run, SPAN)
