"""AdamW with decoupled weight decay, global-norm clipping and a cosine
learning-rate schedule with linear warmup.  The port of
``repro.optim.adamw``: pure functions over the nested-dict parameter trees
of ``models/params.py``, with the JAX package's formulas (clip by the global
norm first; ``delta = mh / (sqrt(vh) + eps) + wd * p``; the schedule, m and
v in float32; each parameter cast back to its own dtype).

Not ``torch.optim``: the state is an ``AdamWState(step, m, v)`` tree of the
JAX package's shape, so a train state checkpoints in the JAX format and
converts one to one (``convert.adamw_state_from_reference``).

``adamw_update`` is out of place, as the JAX function is: it returns new
parameter, m and v tensors and leaves its inputs as they were, so a caller
holding the old state (the restartable loop's initial state) can go back to
it.  It works one leaf at a time, so what it holds beyond the old and the
new state is one leaf's temporaries.  Every scalar (the clip scale, the
learning rate, the bias corrections) stays a 0-d tensor on the parameters'
device: an update makes no host sync.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.params import tree_leaves, tree_map

Tensor = torch.Tensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor        # 0-d int32
    m: Any
    v: Any


def adamw_init(params: Any) -> AdamWState:
    """Zero moments in float32 on each parameter's device, step 0 (on the
    first parameter's device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """The learning rate at ``step`` (a tensor), in float32: linear warmup
    to ``cfg.lr``, then a cosine down to ``min_lr_frac * lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_t = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    decay_t = torch.clamp(decay_t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * decay_t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> Tensor:
    """sqrt of the sum over the leaves of their float32 sums of squares,
    added leaf after leaf in sorted path order."""
    sq = None
    for _, g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def grid_global_norm(grads: Any, specs: Any, mesh) -> Tensor:
    """``global_norm`` of a gradient laid out on a (data, model) grid of
    ranks: ``grads`` this rank's blocks (each whole once summed over the
    axes its spec does not name), ``specs`` their spec tree
    (``launch.specs.param_shardings``).  Each distinct block counts once:
    a rank adds a leaf's float32 sum of squares only where its index is 0
    along every axis the leaf's spec does not name, and the sums are
    all-reduced over 'data', then 'model'.  The same on every rank."""
    from ..sharding import all_reduce_, index_of, unnamed_axes
    sq = None
    for (_, g), (_, spec) in zip(tree_leaves(grads), tree_leaves(specs)):
        if all(index_of(mesh, a) == 0 for a in unnamed_axes(spec, mesh)):
            s = torch.sum(torch.square(g.to(torch.float32)))
            sq = s if sq is None else sq + s
    if sq is None:
        sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    all_reduce_(sq, mesh.data_group)
    all_reduce_(sq, mesh.model_group)
    return torch.sqrt(sq)


def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any, norm: Tensor | None = None):
    """Returns (new_params, new_state, metrics {grad_norm, lr}); the inputs
    are not changed.  ``norm``: the gradient's global norm where the caller
    has it (a grid's, ``grid_global_norm``); else ``global_norm(grads)``."""
    gnorm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.beta1, stepf)
    b2c = 1 - torch.pow(cfg.beta2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
        mh, vh = m / b1c, v / b2c
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    with torch.no_grad():
        out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(step=step, m=_pick(out, 1),
                                     v=_pick(out, 2)), \
        {"grad_norm": gnorm, "lr": lr}


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of each tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
