"""Model assembly: config -> parameter specs -> prefill / decode functions.
The port of ``repro.models.model`` for serving.

The layer stack is ``cfg.layer_pattern`` repeated ``cfg.n_groups`` times, with
per-slot parameters stacked on a leading group axis as in the JAX package;
here it is a Python loop over the groups (the JAX package scans them).
Decode state is a tree of ring-buffer KV caches built from the same
ParamSpec machinery as the parameters (see ``models/attention.py``);
``decode_step`` writes into it in place.

Supported: dense attention slots (``kind='attn'``, global or windowed) with
no MoE, cross-attention or shared attention, and no encoder: phi3-mini-3.8b,
qwen3-14b, gemma3-1b and command-r-plus-104b.  Other slots raise
``NotImplementedError``; training (``chunked_xent``, ``loss_fn``) is not
ported yet either.
"""
from __future__ import annotations

import torch

from ..configs.base import LayerSpec, ModelConfig
from .attention import attn_specs, decode_attention, multihead_attention
from .layers import embed_specs, mlp, mlp_specs, rmsnorm, rmsnorm_specs
from .params import ParamSpec, init_params, stack_specs, tree_map
from .params import count_params as _count_specs

Tensor = torch.Tensor


def _require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder is not ported yet (ROADMAP §A 16)")
    for slot in cfg.layer_pattern:
        if slot.kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {slot.kind} slots are not ported yet "
                f"(ROADMAP §A 16)")
        for flag in ("moe", "cross_attn", "shared_attn"):
            if getattr(slot, flag):
                raise NotImplementedError(
                    f"{cfg.name}: {flag} slots are not ported yet "
                    f"(ROADMAP §A 16)")


def cast_params(params: dict, dtype) -> dict:
    """Cast floating params to the compute dtype once, before the layer
    stack (no copy where a tensor already has it)."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _slot_specs(cfg: ModelConfig, slot: LayerSpec) -> dict:
    d = cfg.d_model
    return {
        "norm1": rmsnorm_specs(d),
        "attn": attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.use_qk_norm),
        "norm2": rmsnorm_specs(d),
        "ffn": mlp_specs(d, cfg.d_ff),
    }


def param_specs(cfg: ModelConfig) -> dict:
    _require_dense(cfg)
    d = cfg.d_model
    slots = {f"slot{i}": _slot_specs(cfg, s)
             for i, s in enumerate(cfg.layer_pattern)}
    specs: dict = {
        "embed": embed_specs(cfg.vocab_size, d),
        "groups": stack_specs(slots, cfg.n_groups),
        "final_norm": rmsnorm_specs(d),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"table": ParamSpec((cfg.vocab_size, d),
                                               ("vocab", "embed"), scale=0.02)}
    return specs


def init(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32):
    """Random parameters on the generator's device."""
    return init_params(param_specs(cfg), generator, dtype)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _cache_len(seq_len: int, window: int) -> int:
    return seq_len if window == 0 else min(seq_len, window)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    _require_dense(cfg)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    kv_axes = (None, "batch", "seq_shard", "kv_heads", "head_dim")
    out = {}
    for i, slot in enumerate(cfg.layer_pattern):
        tc = _cache_len(seq_len, slot.window)
        shape = (cfg.n_groups, batch, tc, kv, dh)
        out[f"slot{i}"] = {"k": ParamSpec(shape, kv_axes, init="zeros"),
                           "v": ParamSpec(shape, kv_axes, init="zeros")}
    return out


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.float32, device=None):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=dtype, device=device),
                    cache_specs(cfg, batch, seq_len))


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _ring_from_prefill(k: Tensor, tc: int) -> Tensor:
    """Convert prefill keys (B,S,KV,D) to ring-cache layout (B,Tc,KV,D):
    token at absolute position p lives at ring row p % Tc."""
    s = k.shape[1]
    if s <= tc:
        pad = k.new_zeros((k.shape[0], tc - s) + tuple(k.shape[2:]))
        return torch.cat([k, pad], dim=1)
    return torch.roll(k[:, s - tc:], shifts=s % tc, dims=1)


def _apply_slot_full(cfg: ModelConfig, slot: LayerSpec, sp: dict, x: Tensor,
                     *, positions: Tensor, k_pos: Tensor, causal: bool,
                     emit_cache: bool, cache_len: int):
    """One pattern slot over a full sequence.  Returns (x, cache_dict)."""
    cache: dict = {}
    h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
    y, (k, v) = multihead_attention(
        sp["attn"], h, h, q_pos=positions, k_pos=k_pos, causal=causal,
        window=slot.window, softcap=cfg.attn_logit_softcap,
        qk_norm=cfg.use_qk_norm, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps, return_kv=True)
    x = x + y
    if emit_cache:
        tc = _cache_len(cache_len, slot.window)
        cache["k"] = _ring_from_prefill(k, tc)
        cache["v"] = _ring_from_prefill(v, tc)
    h = rmsnorm(sp["norm2"], x, cfg.norm_eps)
    return x + mlp(sp["ffn"], h), cache


def _group(tree: dict, g: int) -> dict:
    """The params (or caches) of layer group ``g``: views, no copies."""
    return tree_map(lambda p: p[g], tree)


def _backbone_full(cfg: ModelConfig, params: dict, h: Tensor,
                   positions: Tensor, *, causal: bool, emit_cache: bool,
                   cache_len: int):
    """The pattern groups over a full sequence, one after the other.
    Returns (hidden, caches stacked on the group axis or None)."""
    k_pos = torch.arange(h.shape[1], dtype=positions.dtype, device=h.device)
    cache_list = []
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        caches = {}
        for i, slot in enumerate(cfg.layer_pattern):
            h, caches[f"slot{i}"] = _apply_slot_full(
                cfg, slot, gp[f"slot{i}"], h, positions=positions,
                k_pos=k_pos, causal=causal, emit_cache=emit_cache,
                cache_len=cache_len)
        cache_list.append(caches)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if not emit_cache:
        return h, None
    stacked = {slot: {name: torch.stack([c[slot][name] for c in cache_list])
                      for name in cache_list[0][slot]}
               for slot in cache_list[0]}
    return h, stacked


def _embed_tokens(params: dict, tokens: Tensor, dtype) -> Tensor:
    return params["embed"]["table"].to(dtype)[tokens]


def forward(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            emit_cache: bool = False, max_cache_len: int = 0,
            dtype=torch.bfloat16):
    """Full-sequence forward.  Returns (hidden (B,S,D), caches).

    ``max_cache_len`` sizes the emitted decode caches (>= prompt length +
    planned decode steps); defaults to the prompt length.
    """
    _require_dense(cfg)
    tokens = batch["tokens"]
    params = cast_params(params, dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, -1)
    h = _embed_tokens(params, tokens, dtype)
    return _backbone_full(cfg, params, h, positions, causal=True,
                          emit_cache=emit_cache,
                          cache_len=max(max_cache_len, s))


def _logit_table(cfg: ModelConfig, params: dict) -> Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["table"])


def prefill(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            max_cache_len: int = 0, dtype=torch.bfloat16):
    """Returns (last-token logits (B,V) f32, caches, pos (B,) int32)."""
    h, caches = forward(cfg, params, batch, emit_cache=True,
                        max_cache_len=max_cache_len, dtype=dtype)
    logits = h[:, -1].float() @ _logit_table(cfg, params).float().T
    b, s = batch["tokens"].shape
    return logits, caches, torch.full((b,), s, dtype=torch.int32,
                                      device=h.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _apply_slot_decode(cfg: ModelConfig, sp: dict, x: Tensor, *, pos: Tensor,
                       cache: dict) -> Tensor:
    h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
    x = x + decode_attention(sp["attn"], h, cache["k"], cache["v"], pos=pos,
                             softcap=cfg.attn_logit_softcap,
                             qk_norm=cfg.use_qk_norm,
                             rope_theta=cfg.rope_theta,
                             norm_eps=cfg.norm_eps)
    h = rmsnorm(sp["norm2"], x, cfg.norm_eps)
    return x + mlp(sp["ffn"], h)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: Tensor,
                pos: Tensor, *, dtype=torch.bfloat16):
    """One serving step: tokens (B,1) int, pos (B,) absolute positions.
    Returns (logits (B,V) f32, cache).  The cache is updated IN PLACE (the
    new token's key and value are written into its ring rows) and returned
    as the same object; clone it first to keep the old state."""
    _require_dense(cfg)
    params = cast_params(params, dtype)
    h = _embed_tokens(params, tokens, dtype)
    for g in range(cfg.n_groups):
        gp, gc = _group(params["groups"], g), _group(cache, g)
        for i in range(cfg.period):
            h = _apply_slot_decode(cfg, gp[f"slot{i}"], h, pos=pos,
                                   cache=gc[f"slot{i}"])
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = h[:, 0].float() @ _logit_table(cfg, params).float().T
    return logits, cache


def count_params(cfg: ModelConfig) -> int:
    return _count_specs(param_specs(cfg))
