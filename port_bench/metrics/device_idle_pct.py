"""device_idle_pct: the share of the traced window in which no operation
ran on the device, in % (the profiler's device operations against the
window's span).  ``device_idle_pct.fit``, ``.predict`` and ``.forest``
are this quantity in the cells that report ``fit_s``,
``predict_rows_per_s`` and ``fit_s.forest``."""


def read(run):
    if not run.window_s or not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
