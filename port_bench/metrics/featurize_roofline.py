"""featurize_roofline: B1's share of its roofline on the window's query
rows, in %: ``featurize_kernel``'s device time from the profiler against
the frozen ``counts/featurize.py`` for every row answered."""


def read(run):
    if run.kind != "predict" or not run.rows:
        return None
    cost = run.count("featurize").cost(run.cfg, run.rows)
    return run.roofline(cost, run.kernel_s.get("featurize_kernel", 0.0),
                        "featurize_roofline")
