"""pcg_iters: the solver's iterations a fit, the mean over the traced
window's fits of the program's ``telemetry["iters"]``."""


def read(run):
    if not run.fits:
        return None
    return sum(f["iters"] for f in run.fits) / len(run.fits)
