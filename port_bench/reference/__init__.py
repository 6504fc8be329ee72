"""The benchmark's plain reference of WLSH-KRR, in PyTorch alone.

It imports nothing of the program under test (neither ``repro_torch`` nor
the JAX package) and takes nothing the program made: it hashes the points,
builds the tables and solves from the benchmark's own inputs.
"""
from .wlsh import (bucket_value, features, fit, loads, matvec, pcg,
                   predict, rel_err)

__all__ = ["bucket_value", "features", "fit", "loads", "matvec", "pcg",
           "predict", "rel_err"]
