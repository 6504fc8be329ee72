"""predict_mfu: the useful float32 operations of every row answered in the
traced window (frozen ``counts/predict.py``: featurize and readout) over
the window's wall time times the card's float32 peak, in %."""


def read(run):
    if run.kind != "predict" or not run.rows or not run.peaks:
        return None
    flops = run.count("predict").cost(run.cfg, run.rows)["flops"]
    return 100.0 * flops / (run.window_s * run.peaks["f32_flops_per_s"])
