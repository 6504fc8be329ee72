"""readout_roofline: the readout's (``readout_kernel``) share of its
roofline on the window's query rows, in %, against the frozen
``counts/readout.py``."""


def read(run):
    if run.kind != "predict" or not run.rows:
        return None
    cost = run.count("readout").cost(run.cfg, run.rows)
    return run.roofline(cost, run.kernel_s.get("readout_kernel", 0.0),
                        "readout_roofline")
