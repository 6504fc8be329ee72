"""layout_ms: building the table index and its slot-sorted layout, in ms
a fit: the mean of the program's ``telemetry["phase_seconds"]["layout"]``
over the traced window's fits."""


def read(run):
    if not run.fits:
        return None
    return 1e3 * sum(f["phase_seconds"]["layout"] for f in run.fits) / len(
        run.fits)
