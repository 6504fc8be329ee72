"""Step-function builders shared by the trainer and the server: the port of
``repro.launch.steps``.

The train step takes the gradient with autograd: the master parameters
(float32) are detached copies that share their storage and record a
gradient; ``model.forward`` casts them to the compute dtype once, and
autograd carries float32 gradients back through that cast.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import model, sharded
from ..models.params import tree_map
from ..optim import AdamWConfig, adamw_init, adamw_update

# the profiler's name for the train step's optimizer update
OPTIMIZER_RANGE = "adamw_update"


def _grads(cfg: ModelConfig, params: dict, batch: dict, dtype):
    """(detached metrics, gradient tree of params' structure) of one
    batch."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        total, metrics = model.loss_fn(cfg, leaves, batch, dtype=dtype)
        total.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: p.grad, leaves))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    dtype=torch.bfloat16, num_microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {loss, aux_loss, grad_norm, lr} as 0-d tensors.

    num_microbatches > 1 splits the batch along its first axis, sums the
    microbatches' gradients in order, divides the sum by their count once
    and averages loss and aux: activation memory scales down while the
    gradient is the full batch's (up to summation order).
    """
    def step(params, opt_state, batch):
        nm = num_microbatches
        if nm == 1:
            metrics, grads = _grads(cfg, params, batch, dtype)
        else:
            b = batch["tokens"].shape[0]
            if b % nm:
                raise ValueError(f"batch {b} does not split into {nm} "
                                 f"microbatches")
            gsum = lsum = asum = None
            for i in range(nm):
                mb = {k: v[i * (b // nm):(i + 1) * (b // nm)]
                      for k, v in batch.items()}
                m, g = _grads(cfg, params, mb, dtype)
                if gsum is None:
                    gsum, lsum, asum = g, m["loss"], m["aux_loss"]
                else:       # in place: gsum is this step's own buffer
                    tree_map(torch.Tensor.add_, gsum, g)
                    lsum, asum = lsum + m["loss"], asum + m["aux_loss"]
                del g
            grads = tree_map(lambda g: g.div_(nm), gsum)
            metrics = {"loss": lsum / nm, "aux_loss": asum / nm}
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            params, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                          opt_state, params)
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
                     dtype=torch.float32):
    """(params, AdamW state) with parameters drawn from ``generator`` on its
    device."""
    params = model.init(cfg, generator, dtype)
    return params, adamw_init(params)
