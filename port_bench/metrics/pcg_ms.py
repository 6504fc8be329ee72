"""pcg_ms: the solve's wall time a fit, in ms: the mean over the traced
window's fits of the program's own ``telemetry["phase_seconds"]["pcg"]``
(a host clock between two device syncs)."""


def read(run):
    if not run.fits:
        return None
    return 1e3 * sum(f["phase_seconds"]["pcg"] for f in run.fits) / len(
        run.fits)
