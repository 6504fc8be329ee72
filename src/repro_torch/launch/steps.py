"""Step-function builders shared by the trainer and the server: the port of
``repro.launch.steps``.

The train step takes the gradient with autograd: the master parameters
(float32) are detached copies that share their storage and record a
gradient; ``model.forward`` casts them to the compute dtype once, and
autograd carries float32 gradients back through that cast.

On a (data, model) grid of ranks (``mesh=``, the counterpart of the JAX
step jitted with ``param_shardings``, ``opt_shardings`` and
``batch_shardings``) each rank holds its blocks of the parameters and of
the AdamW state and is given the global batch.  Its backward starts from
its share of the loss (``models.sharded.loss_fn``); each leaf's gradient
is then summed over the grid axes its spec does not name (the leaf is
replicated there; the axes it is gathered over at use already summed it
in the gather's reduce-scatter), which pins the gradient to the
parameter's layout as the JAX step's ``constrain_tree(g, grad_axes)``
does; the clip's global norm counts each distinct block once
(``optim.grid_global_norm``) and AdamW updates the rank's blocks.
"""
from __future__ import annotations

import torch

from .. import roofline
from ..configs.base import ModelConfig
from ..models import model, sharded
from ..models.params import tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_init, adamw_update, grid_global_norm
from ..sharding import all_reduce_, group_of, unnamed_axes
from .specs import param_shardings

# the profiler's name for the train step's optimizer update
OPTIMIZER_RANGE = "adamw_update"


def _grads(loss, params: dict, batch: dict):
    """(detached metrics, gradient tree of params' structure) of one
    batch; ``loss(params, batch)`` -> (total, metrics)."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = loss(leaves, batch)
        total.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: p.grad, leaves))


def sum_replicas_(grads: dict, lay: sharded.GridLayout) -> dict:
    """Each leaf of ``grads`` (a rank's partial gradients, its blocks'
    shapes) summed in place over the grid axes its spec does not name,
    the data axes then 'model'; a one-rank group runs its all-reduce
    too."""
    for (_, g), (_, spec) in zip(tree_leaves(grads), tree_leaves(lay.spec)):
        for axis in unnamed_axes(spec, lay.mesh):
            all_reduce_(g, group_of(lay.mesh, axis))
    return grads


def make_grad_step(cfg: ModelConfig, dtype=torch.bfloat16,
                   num_microbatches: int = 1, mesh=None):
    """(params, batch) -> (metrics {loss, aux_loss}, gradient tree): the
    train step's gradient.  num_microbatches > 1 splits the batch along its
    first axis, sums the microbatches' gradients in order (in place),
    divides the sum by their count once and averages loss and aux:
    activation memory scales down while the gradient is the full batch's
    (up to summation order).  With ``mesh``, this rank's parameter blocks
    and the GLOBAL batch in, its gradient blocks out (whole: summed over
    the ranks that hold the same block); a microbatch is a block of the
    global batch's rows, whose rows each data rank then cuts, as the JAX
    step's reshape of the global batch.  A dry run (meta tensors under
    ``roofline.Tracer``) traces the first two microbatches and counts the
    second for all but the first (``roofline.trips``)."""
    if mesh is None:
        def loss(p, b):
            return model.loss_fn(cfg, p, b, dtype=dtype)
    else:
        lay = sharded.GridLayout(cfg, mesh)

        def loss(p, b):
            return sharded.loss_fn(lay, p, b, dtype=dtype)

    def grad_step(params, batch):
        nm = num_microbatches
        if nm == 1:
            metrics, grads = _grads(loss, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % nm:
                raise ValueError(f"batch {b} does not split into {nm} "
                                 f"microbatches")
            gsum = lsum = asum = None
            for i in roofline.trips(nm, batch["tokens"]):
                mb = {k: v[i * (b // nm):(i + 1) * (b // nm)]
                      for k, v in batch.items()}
                m, g = _grads(loss, params, mb)
                if gsum is None:
                    gsum, lsum, asum = g, m["loss"], m["aux_loss"]
                else:       # in place: gsum is this step's own buffer
                    tree_map(torch.Tensor.add_, gsum, g)
                    lsum, asum = lsum + m["loss"], asum + m["aux_loss"]
                del g
            grads = tree_map(lambda g: g.div_(nm), gsum)
            metrics = {"loss": lsum / nm, "aux_loss": asum / nm}
        if mesh is not None:
            sum_replicas_(grads, lay)
        return metrics, grads

    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    dtype=torch.bfloat16, num_microbatches: int = 1,
                    mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {loss, aux_loss, grad_norm, lr} as 0-d tensors: ``make_grad_step``'s
    gradient, then AdamW.  With ``mesh`` (a ``launch.mesh.Mesh``), on that
    grid: this rank's blocks of the parameters and the AdamW state
    (``init_train_state(mesh=)``, or restored by ``launch.specs.
    param_shardings`` and ``opt_shardings``) and the global batch in, its
    updated blocks out; the metrics are global and the same on every rank.
    """
    grad_step = make_grad_step(cfg, dtype, num_microbatches, mesh)
    specs = None if mesh is None else param_shardings(cfg, mesh)

    def step(params, opt_state, batch):
        metrics, grads = grad_step(params, batch)
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            norm = None if mesh is None else grid_global_norm(grads, specs,
                                                              mesh)
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, grads, opt_state, params, norm=norm)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


def make_eval_step(cfg: ModelConfig, dtype=torch.bfloat16):
    """(params, batch) -> {loss, aux_loss}, with no autograd record."""
    @torch.no_grad()
    def step(params, batch):
        _, metrics = model.loss_fn(cfg, params, batch, dtype=dtype)
        return metrics
    return step


def make_prefill_step(cfg: ModelConfig, max_cache_len: int = 0,
                      dtype=torch.bfloat16, mesh=None):
    """(params, batch) -> (last-token logits, cache, pos).  With ``mesh``
    the step runs on that grid of ranks (``models.sharded.prefill``, its
    layout built once here): this rank's parameter blocks and the global
    batch in, its rows' logits over its vocab range, its cache blocks and
    positions out."""
    if mesh is not None:
        lay = sharded.GridLayout(cfg, mesh)

        def grid_step(params, batch):
            return sharded.prefill(lay, params, batch,
                                   max_cache_len=max_cache_len, dtype=dtype)
        return grid_step

    def step(params, batch):
        return model.prefill(cfg, params, batch, max_cache_len=max_cache_len,
                             dtype=dtype)
    return step


def make_decode_step(cfg: ModelConfig, dtype=torch.bfloat16, mesh=None):
    """(params, cache, tokens (B,1), pos (B,)) -> (logits, cache); the cache
    is updated in place.  With ``mesh``, on that grid
    (``models.sharded.decode_step``): this rank's rows' tokens and
    positions and its ``ShardedCache``."""
    if mesh is not None:
        lay = sharded.GridLayout(cfg, mesh)

        def grid_step(params, cache, tokens, pos):
            return sharded.decode_step(lay, params, cache, tokens, pos,
                                       dtype=dtype)
        return grid_step

    def step(params, cache, tokens, pos):
        return model.decode_step(cfg, params, cache, tokens, pos, dtype=dtype)
    return step


def source_inputs(cfg: ModelConfig, batch: int,
                  generator: torch.Generator) -> dict:
    """The cross-attention source of a batch of ``batch`` rows, on the
    generator's device, as the JAX CLIs draw it: ``frames`` (B, n_frames,
    d_model) for an encoder, ``patches`` (B, source_len, d_model) for a
    VLM, each 0.02 times a standard normal in float32; empty for the other
    archs."""
    if cfg.encoder is not None:
        name, length = "frames", cfg.encoder.n_frames
    elif cfg.cross_attn_source_len:
        name, length = "patches", cfg.cross_attn_source_len
    else:
        return {}
    x = torch.randn((batch, length, cfg.d_model), generator=generator,
                    device=generator.device)
    return {name: 0.02 * x}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     dtype=torch.float32, mesh=None):
    """(params, AdamW state) with parameters drawn from ``generator`` on its
    device.  With ``mesh``, this rank's blocks of the same draws
    (``launch.serve.init_local``: leaf by leaf, each cut by
    ``param_shardings`` and moved to ``mesh.device``) and the AdamW state
    of those blocks."""
    if mesh is None:
        params = model.init(cfg, generator, dtype)
    else:
        from .serve import init_local
        params = init_local(cfg, mesh, generator, dtype)
    return params, adamw_init(params)
