"""Carry state fitted by the JAX package over to the port.

``lsh_from_reference`` takes the JAX package's ``LSHParams`` (w, z as
float32, r1, r2 as uint32; anything ``numpy.asarray`` reads) and
``model_from_reference`` a fitted ``WLSHKRRModel`` (beta, tables,
table_size, bucket_name).  Both only read attributes and convert through
numpy, so this module imports neither JAX nor the JAX package.  A converted
model predicts through the port as the JAX model does.
"""
from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device
from .core.krr import WLSHKRRModel
from .core.lsh import LSHParams, lsh_params_from_numpy


def lsh_from_reference(lsh, device=None) -> LSHParams:
    """The port's LSHParams from the JAX package's, on ``device``."""
    dev = resolve_device(device)
    r1, r2 = np.asarray(lsh.r1), np.asarray(lsh.r2)
    if r1.dtype != np.uint32 or r2.dtype != np.uint32:
        raise ValueError(f"r1/r2 must be uint32, got {r1.dtype}/{r2.dtype}")
    return lsh_params_from_numpy(np.asarray(lsh.w), np.asarray(lsh.z), r1,
                                 r2, dev)


def _tensor(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def model_from_reference(model, device=None) -> WLSHKRRModel:
    """The port's WLSHKRRModel from a model fitted by the JAX package."""
    dev = resolve_device(device)
    col_iters = getattr(model, "cg_col_iters", None)
    return WLSHKRRModel(
        lsh=lsh_from_reference(model.lsh, dev),
        bucket_name=str(model.bucket_name),
        beta=_tensor(model.beta, np.float32, dev),
        tables=_tensor(model.tables, np.float32, dev),
        table_size=int(model.table_size),
        cg_iters=_tensor(model.cg_iters, np.int32, dev),
        cg_resnorm=_tensor(model.cg_resnorm, np.float32, dev),
        precond=str(getattr(model, "precond", "none")),
        cg_col_iters=None if col_iters is None
        else _tensor(col_iters, np.int32, dev),
        solve_fallback=str(getattr(model, "solve_fallback", "")))
