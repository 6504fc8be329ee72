"""Carry state fitted by the JAX package over to the port.

``lsh_from_reference`` takes the JAX package's ``LSHParams`` (w, z as
float32, r1, r2 as uint32; anything ``numpy.asarray`` reads),
``wlsh_attn_from_reference`` its ``WLSHAttnParams`` (proj, w, z float32,
r1 uint32) and
``model_from_reference`` a fitted ``WLSHKRRModel`` (beta, tables,
table_size, bucket_name).  Both only read attributes and convert through
numpy, so this module imports neither JAX nor the JAX package.  A converted
model predicts through the port as the JAX model does.

``lm_params_from_reference`` and ``lm_cache_from_reference`` take the LM
stack's parameter and decode-cache trees (nested dicts of arrays, the stacked
group axis first) and give tensor trees with the same keys;
``adamw_state_from_reference`` takes the JAX package's ``AdamWState`` (step,
m, v), so a JAX train state continues in the port's train step.
``local_lm_params`` cuts the JAX package's LM parameters into one rank's
blocks of a (data, model) grid, by ``launch.specs.param_shardings``.
"""
from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device
from .core.krr import WLSHKRRModel
from .core.lsh import LSHParams, lsh_params_from_numpy
from .models.wlsh_attention import (WLSHAttnParams,
                                    wlsh_attn_params_from_numpy)
from .optim.adamw import AdamWState


def lsh_from_reference(lsh, device=None) -> LSHParams:
    """The port's LSHParams from the JAX package's, on ``device``."""
    dev = resolve_device(device)
    r1, r2 = np.asarray(lsh.r1), np.asarray(lsh.r2)
    if r1.dtype != np.uint32 or r2.dtype != np.uint32:
        raise ValueError(f"r1/r2 must be uint32, got {r1.dtype}/{r2.dtype}")
    return lsh_params_from_numpy(np.asarray(lsh.w), np.asarray(lsh.z), r1,
                                 r2, dev)


def wlsh_attn_from_reference(params, device=None) -> WLSHAttnParams:
    """The port's WLSHAttnParams from the JAX package's, on ``device``."""
    r1 = np.asarray(params.r1)
    if r1.dtype != np.uint32:
        raise ValueError(f"r1 must be uint32, got {r1.dtype}")
    return wlsh_attn_params_from_numpy(
        np.asarray(params.proj), np.asarray(params.w), np.asarray(params.z),
        r1, resolve_device(device))


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


def _tensor_tree(tree, device):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``,
    dtype kept (bfloat16, which numpy lacks, goes through float32)."""
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_reference(params, device=None) -> dict:
    """The port's LM parameter tree from the JAX package's (``model.init``),
    on ``device``."""
    return _tensor_tree(params, resolve_device(device))


def local_lm_params(reference_params, cfg, mesh, dtype=torch.float32,
                    device=None) -> dict:
    """This rank of ``mesh``'s blocks of the JAX package's LM parameters
    (nested dicts of arrays, as ``model.init`` gives them), laid out by
    ``param_shardings(cfg, mesh)``: each leaf is cut on the host and only
    its block goes to ``device`` in ``dtype``, one leaf at a time, so no
    rank holds the whole model on its device."""
    from .launch.specs import param_shardings
    from .sharding import local_block
    dev = resolve_device(device)

    def one(ref, spec):
        a = np.asarray(ref)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        block = np.array(local_block(a, spec, mesh))     # a copy
        return torch.from_numpy(block).to(device=dev, dtype=dtype)

    def walk(ref, spec):
        if isinstance(spec, dict):
            return {k: walk(ref[k], spec[k]) for k in spec}
        return one(ref, spec)
    return walk(reference_params, param_shardings(cfg, mesh))


def lm_cache_from_reference(cache, device=None) -> dict:
    """The port's decode cache from the JAX package's (``model.prefill`` or
    ``model.init_cache``), on ``device``."""
    return _tensor_tree(cache, resolve_device(device))


def adamw_state_from_reference(state, device=None) -> AdamWState:
    """The port's AdamWState from the JAX package's (step as an int32
    scalar, m and v as float32 trees), on ``device``."""
    dev = resolve_device(device)
    return AdamWState(step=_tensor(state.step, np.int32, dev).reshape(()),
                      m=_tensor_tree(state.m, dev),
                      v=_tensor_tree(state.v, dev))
