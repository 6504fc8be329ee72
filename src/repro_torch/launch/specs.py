"""Abstract inputs, their layouts over a grid, and useful-FLOP accounting
for every (architecture x shape) cell.  The port of ``repro.launch.specs``,
without its XLA parts.

``batch_specs`` and ``decode_specs`` give ``device="meta"`` tensors, the
PyTorch counterpart of ``jax.ShapeDtypeStruct``: shape and dtype, no
storage.  ``batch_shardings``, ``param_shardings`` and ``cache_shardings``
give the spec tree (``repro_torch.sharding.spec_for``'s entries per dim)
that lays each leaf out over a mesh, as the JAX functions give their
``NamedSharding`` trees; ``models.sharded`` serves and trains every LM arch
by them on a (data, model) grid of ranks (``opt_shardings`` lays out the
AdamW state), and ``shard_bytes`` is the bytes one rank holds.
``TRAIN_MICROBATCHES`` is each arch's microbatch count for a train cell.
``useful_flops`` is the model-FLOP numerator of a roofline share.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..models import model
from ..models.mamba2 import mamba2_dims
from ..models.params import tree_leaves, tree_map
from ..optim import AdamWState
from ..sharding import local_shape, spec_for, tree_shardings

META = torch.device("meta")

# microbatch count per arch for train cells, copied from the JAX package's
# dry run (src/repro/launch/dryrun.py, TRAIN_MICROBATCHES: chosen there so
# a v5e device's temporaries fit its 16 GB of HBM)
TRAIN_MICROBATCHES: dict[str, int] = {
    "phi3-mini-3.8b": 1, "qwen3-14b": 1, "gemma3-1b": 1,
    "command-r-plus-104b": 4, "llama4-scout-17b-a16e": 2, "mixtral-8x22b": 4,
    "zamba2-7b": 2, "rwkv6-1.6b": 1, "llama-3.2-vision-90b": 4,
    "whisper-large-v3": 1,
}


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> dict:
    """Meta tensors of a train/prefill batch: tokens (and labels) int32,
    the encoder's frames or the VLM's patches in ``dtype``."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
    if cfg.encoder is not None:
        specs["frames"] = torch.empty((b, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=dtype, device=META)
    elif cfg.cross_attn_source_len:
        specs["patches"] = torch.empty(
            (b, cfg.cross_attn_source_len, cfg.d_model), dtype=dtype,
            device=META)
    return specs


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    axes = {"tokens": ("batch", None)}
    if shape.kind == "train":
        axes["labels"] = ("batch", None)
    if cfg.encoder is not None:
        axes["frames"] = ("batch", None, None)
    elif cfg.cross_attn_source_len:
        axes["patches"] = ("batch", None, None)
    return axes


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, dtype=torch.bfloat16):
    """(cache, tokens (B,1), pos (B,)) meta tensors of a decode cell.  The
    cache is ``model.init_cache``'s: its recurrent states float32, as the
    prefill emits them, the rest in ``dtype`` (the JAX package's
    ``abstract_cache`` puts every leaf in ``dtype``)."""
    b, s = shape.global_batch, shape.seq_len
    cache = model.init_cache(cfg, b, s, dtype, device=META)
    return (cache, torch.empty((b, 1), dtype=torch.int32, device=META),
            torch.empty((b,), dtype=torch.int32, device=META))


# ---------------------------------------------------------------------------
# layouts over a mesh (spec trees; a mesh is a dict of axis sizes or a
# launch.mesh.Mesh)
# ---------------------------------------------------------------------------

def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    dtype=torch.bfloat16) -> dict:
    return tree_shardings(batch_axes(cfg, shape),
                          batch_specs(cfg, shape, dtype), mesh)


def param_shardings(cfg: ModelConfig, mesh, dtype=torch.float32) -> dict:
    return tree_shardings(model.param_axes(cfg),
                          model.abstract_params(cfg, dtype), mesh)


def cache_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return tree_shardings(model.cache_axes(cfg, b, s),
                          model.abstract_cache(cfg, b, s, dtype), mesh)


def opt_shardings(cfg: ModelConfig, mesh) -> AdamWState:
    """The AdamW state's layout: m and v as the float32 parameters, the
    step counter replicated (the JAX dry run's ``_opt_shardings``)."""
    pspec = param_shardings(cfg, mesh)
    return AdamWState(step=(), m=pspec, v=pspec)


def abstract_train_state(cfg: ModelConfig) -> dict:
    """A train state ``{"params", "opt"}`` as meta tensors: the float32
    parameters and their AdamW state (the template a checkpoint of one is
    restored into)."""
    params = model.abstract_params(cfg, torch.float32)
    return {"params": params, "opt": AdamWState(
        step=torch.empty((), dtype=torch.int32, device=META), m=params,
        v=params)}


def train_state_placement(cfg: ModelConfig, mesh) -> dict:
    """{keystr path: spec} of every leaf of a ``{"params", "opt"}`` train
    state by ``param_shardings`` and ``opt_shardings``: the placement
    ``checkpoint.restore_resharded`` cuts each rank's blocks by."""
    opt = opt_shardings(cfg, mesh)
    out = {f"['params']{p}": s for p, s in
           tree_leaves(param_shardings(cfg, mesh))}
    for name in ("m", "v"):
        out.update({f"['opt'].{name}{p}": s for p, s in
                    tree_leaves(getattr(opt, name))})
    out["['opt'].step"] = opt.step
    return out


def scalar_sharding(mesh, axes=()):
    return spec_for(axes, (1,) * len(axes), mesh)


def vec_sharding(mesh, shape, axes):
    return spec_for(axes, shape, mesh)


def _local_bytes(tree, spec_tree, mesh) -> int:
    """Bytes of one rank's blocks of a meta-tensor tree laid out by
    ``spec_tree``."""
    sizes = tree_map(lambda t, spec: math.prod(local_shape(
        t.shape, spec, mesh)) * t.element_size(), tree, spec_tree)
    return sum(n for _, n in tree_leaves(sizes))


def shard_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh,
                param_dtype=torch.float32,
                cache_dtype=torch.float32) -> dict[str, int]:
    """The bytes one rank of ``mesh`` holds for a cell, from the local
    shapes of meta tensors (no process group, no storage): the parameters
    in ``param_dtype``; for a train cell the float32 AdamW state (m and v,
    laid out as the parameters; its step counter is a replicated int32);
    for prefill and decode the decode cache (``init_cache``'s dtypes with
    ``cache_dtype``); the batch (``batch_specs``' tokens and labels, and
    whisper's frames or a VLM's patches in bfloat16 as the JAX dry run
    counts them; a decode cell's tokens (B, 1) and positions (B,)); and
    their total.  The memory columns of the JAX dry run (argument bytes a
    device), without its compiler's temporaries."""
    params = model.abstract_params(cfg, param_dtype)
    pspec = tree_shardings(model.param_axes(cfg), params, mesh)
    out = {"params": _local_bytes(params, pspec, mesh)}
    if shape.kind == "train":
        f32 = model.abstract_params(cfg, torch.float32)
        out["opt_state"] = 2 * _local_bytes(f32, pspec, mesh) + 4
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tok = spec_for(("batch", None), (b, 1), mesh)
        pos = spec_for(("batch",), (b,), mesh)
        out["batch"] = 4 * (math.prod(local_shape((b, 1), tok, mesh))
                            + math.prod(local_shape((b,), pos, mesh)))
    else:
        batch = batch_specs(cfg, shape)
        out["batch"] = _local_bytes(
            batch, tree_shardings(batch_axes(cfg, shape), batch, mesh), mesh)
    if shape.kind != "train":
        cache = model.abstract_cache(cfg, b, s, cache_dtype)
        out["cache"] = _local_bytes(
            cache, tree_shardings(model.cache_axes(cfg, b, s), cache, mesh),
            mesh)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# useful-FLOP accounting (model FLOPs for the roofline share)
# ---------------------------------------------------------------------------

def _count(specs, pred) -> int:
    """Parameters of the leaves whose path (as ``jax.tree_util.keystr``
    writes it) satisfies ``pred``."""
    return sum(math.prod(leaf.shape) for path, leaf in tree_leaves(specs)
               if pred(path))


def matmul_params(cfg: ModelConfig) -> tuple[int, int]:
    """(active, total) matmul parameters: embedding/unembedding tables and
    norm scales excluded; MoE experts scaled by top_k/n_experts for
    'active'."""
    specs = model.param_specs(cfg)

    def is_table(k):
        return ("embed" in k and "table" in k) or \
            ("unembed" in k and "table" in k)

    def is_norm(k):
        return "norm" in k or "ln_x" in k or k.endswith("scale']")

    total_all = _count(specs, lambda k: not (is_table(k) or is_norm(k)))
    moe_w = _count(specs, lambda k: ("w_gate" in k or "w_up" in k or
                                     "w_down" in k) and "ffn" in k)
    if cfg.moe is not None and moe_w:
        active = total_all - moe_w + moe_w * cfg.moe.top_k // cfg.moe.n_experts
    else:
        active = total_all
    return active, total_all


def _attn_flops_token(cfg: ModelConfig, t_ctx: float) -> float:
    """Score+value FLOPs for ONE query token against t_ctx keys, all
    layers."""
    per_layer = 4.0 * t_ctx * cfg.n_heads * cfg.head_dim   # 2 matmuls x 2 flop
    total = 0.0
    for s in cfg.layer_pattern:
        reps = cfg.n_groups
        if s.kind == "attn":
            eff = min(t_ctx, s.window) if s.window else t_ctx
            total += per_layer / t_ctx * eff * reps
        if s.shared_attn:
            win = s.window or 4096
            total += per_layer / t_ctx * min(t_ctx, win) * reps
        if s.cross_attn:
            total += 4.0 * cfg.cross_attn_source_len * cfg.n_heads * \
                cfg.head_dim * reps
    return total


def _ssm_flops_token(cfg: ModelConfig) -> float:
    if cfg.ssm is None:
        return 0.0
    total = 0.0
    for s in cfg.layer_pattern:
        if s.kind == "mamba2":
            dims = mamba2_dims(cfg.d_model, cfg.ssm)
            total += 4.0 * dims.n_heads * dims.head_dim * dims.state * \
                cfg.n_groups
        elif s.kind == "rwkv6":
            total += 4.0 * cfg.n_heads * cfg.head_dim ** 2 * cfg.n_groups
    return total


def _encoder_params(cfg: ModelConfig) -> int:
    return _count(model.param_specs(cfg),
                  lambda k: "encoder" in k and "norm" not in k)


def useful_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Model FLOPs of the cell: 6 N_active per token for train (2 forward +
    4 backward), 2 N_active per token for prefill/decode, plus attention,
    SSM and logits terms."""
    b, s = shape.global_batch, shape.seq_len
    n_active, _ = matmul_params(cfg)
    logits_flops_tok = 2.0 * cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = b * s
        avg_ctx = s / 2.0   # causal average context
        fwd_tok = 2.0 * n_active + _attn_flops_token(cfg, avg_ctx) + \
            _ssm_flops_token(cfg) + logits_flops_tok
        flops = 3.0 * fwd_tok * tokens          # bwd = 2x fwd
        if cfg.encoder is not None:
            flops += 3.0 * 2.0 * _encoder_params(cfg) * b * \
                cfg.encoder.n_frames
        return flops
    if shape.kind == "prefill":
        tokens = b * s
        avg_ctx = s / 2.0
        fwd_tok = 2.0 * n_active + _attn_flops_token(cfg, avg_ctx) + \
            _ssm_flops_token(cfg)
        flops = fwd_tok * tokens + logits_flops_tok * b   # last-token logits
        if cfg.encoder is not None:
            flops += 2.0 * _encoder_params(cfg) * b * cfg.encoder.n_frames
        return flops
    # decode: one token per sequence against a seq_len cache
    fwd_tok = 2.0 * n_active + _attn_flops_token(cfg, float(s)) + \
        _ssm_flops_token(cfg) + logits_flops_tok
    return fwd_tok * b
