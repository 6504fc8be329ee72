"""A whole fit: featurize the n points, ``iters`` matvecs of the solve,
and the tables.  The slot-sorted layout and the solve's vector updates
are the program's own choices or small beside these, and are not counted.
"""
from . import featurize, matvec, tables


def cost(cfg, iters):
    once = (featurize.cost(cfg, cfg["n_points"]), tables.cost(cfg))
    mv = matvec.cost(cfg)
    return {key: sum(p[key] for p in once) + iters * mv[key]
            for key in ("flops", "bytes")}
