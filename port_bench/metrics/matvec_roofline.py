"""matvec_roofline: the fused matvec's share of its roofline, in %.

Device time: B2's kernels (``mv_chunk_kernel``, ``mv_walk_kernel``,
``mv_fix_kernel``) and the combine through ``readout_kernel``, which in a
fit only the matvec launches, from the profiler.  Work: the frozen
``counts/matvec.py`` times the matvecs the program's counter
(``bin_fused_matvec``) saw in the window.
"""
KERNELS = ("mv_chunk_kernel", "mv_walk_kernel", "mv_fix_kernel",
           "readout_kernel")


def read(run):
    if run.kind != "fit":
        return None
    seconds = sum(run.kernel_s.get(k, 0.0) for k in KERNELS)
    times = run.launches.get("bin_fused_matvec", 0)
    return run.roofline(run.count("matvec").cost(run.cfg), seconds,
                        "matvec_roofline", times)
