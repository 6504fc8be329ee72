"""A whole predict call of ``rows`` queries: featurize them, then the
readout."""
from . import featurize, readout


def cost(cfg, rows):
    a, b = featurize.cost(cfg, rows), readout.cost(cfg, rows)
    return {key: a[key] + b[key] for key in ("flops", "bytes")}
