"""fit_mfu: the fits' useful float32 operations (frozen
``counts/fit.py`` at each fit's measured iterations) over the traced
window's wall time times the card's float32 peak, in %."""


def read(run):
    if run.kind != "fit" or not run.fits or not run.peaks:
        return None
    fit = run.count("fit")
    flops = sum(fit.cost(run.cfg, f["iters"])["flops"] for f in run.fits)
    return 100.0 * flops / (run.window_s * run.peaks["f32_flops_per_s"])
