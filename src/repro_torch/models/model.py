"""Model assembly: config -> parameter specs -> train / prefill / decode
functions.  The port of ``repro.models.model``.

The layer stack is ``cfg.layer_pattern`` repeated ``cfg.n_groups`` times, with
per-slot parameters stacked on a leading group axis as in the JAX package;
here it is a Python loop over the groups (the JAX package scans them).
Decode state is a tree of ring-buffer KV caches built from the same
ParamSpec machinery as the parameters (see ``models/attention.py``);
``decode_step`` writes into it in place.

Training: ``loss_fn`` is the forward plus ``chunked_xent``, and autograd
gives the gradient.  Where autograd records (``torch.is_grad_enabled()``),
activations are rematerialized as the JAX package's ``jax.checkpoint`` does
(``torch.utils.checkpoint``, non-reentrant): each slot when the pattern's
period is above 4 (gemma3's 26-slot pattern is one group), else each group,
and each chunk of the cross-entropy, so one chunk's (B, 512, V) float32
logits is live at a time.

Supported: dense attention slots (``kind='attn'``, global or windowed) with
no MoE, cross-attention or shared attention, and no encoder: phi3-mini-3.8b,
qwen3-14b, gemma3-1b and command-r-plus-104b.  Other slots raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerSpec, ModelConfig
from .attention import attn_specs, decode_attention, multihead_attention
from .layers import embed_specs, mlp, mlp_specs, rmsnorm, rmsnorm_specs
from .params import ParamSpec, init_params, stack_specs, tree_map
from .params import count_params as _count_specs

Tensor = torch.Tensor

AUX_LOSS_WEIGHT = 0.01
XENT_CHUNK = 512


def _require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet, naming its ROADMAP item."""
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder is not ported yet (ROADMAP §A item 9)")
    for slot in cfg.layer_pattern:
        if slot.kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {slot.kind} slots are not ported yet "
                f"(ROADMAP §A item 9)")
        for flag in ("moe", "cross_attn", "shared_attn"):
            if getattr(slot, flag):
                raise NotImplementedError(
                    f"{cfg.name}: {flag} slots are not ported yet "
                    f"(ROADMAP §A item 9)")


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
    Returns (hidden, caches stacked on the group axis or None).  Where
    autograd records, each slot (period > 4) or each group is
    rematerialized in the backward pass."""
    k_pos = torch.arange(h.shape[1], dtype=positions.dtype, device=h.device)
    remat = torch.is_grad_enabled()
    remat_slots = cfg.period > 4

    def slot_fn(slot, sp, x):
        return _apply_slot_full(cfg, slot, sp, x, positions=positions,
                                k_pos=k_pos, causal=causal,
                                emit_cache=emit_cache, cache_len=cache_len)

    def group_fn(gp, x, slot_remat):
        caches = {}
        for i, slot in enumerate(cfg.layer_pattern):
            if slot_remat:
                x, caches[f"slot{i}"] = checkpoint(
                    slot_fn, slot, gp[f"slot{i}"], x, use_reentrant=False)
            else:
                x, caches[f"slot{i}"] = slot_fn(slot, gp[f"slot{i}"], x)
        return x, caches

    cache_list = []
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        if remat and not remat_slots:
            h, caches = checkpoint(group_fn, gp, h, False,
                                   use_reentrant=False)
        else:
            h, caches = group_fn(gp, h, remat)
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
    """Full-sequence forward.  Returns (hidden (B,S,D), aux, caches); aux is
    the auxiliary loss, a float32 zero for the dense slots.

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
    h, caches = _backbone_full(cfg, params, h, positions, causal=True,
                               emit_cache=emit_cache,
                               cache_len=max(max_cache_len, s))
    return h, torch.zeros((), dtype=torch.float32, device=h.device), caches


def _logit_table(cfg: ModelConfig, params: dict) -> Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["table"])


class _LogitsF32(torch.autograd.Function):
    """(N, D) @ (V, D)^T in bf16 with float32 accumulation and a float32
    result, on the card (``torch.mm``'s ``out_dtype``, which has no
    derivative of its own).  The backward multiplies the float32 logits'
    gradient as the JAX package's transpose does, rounding only the
    results to the inputs' dtype: the gradient is split into a bf16 head
    and the bf16 rounding of its remainder (16 bits of it), and each is
    multiplied with float32 accumulation."""

    @staticmethod
    def forward(ctx, h, table):
        ctx.save_for_backward(h, table)
        return torch.mm(h, table.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, table = ctx.saved_tensors
        hi = g.to(h.dtype)
        lo = (g - hi).to(h.dtype)
        gh = torch.mm(hi, table, out_dtype=torch.float32)
        gh += torch.mm(lo, table, out_dtype=torch.float32)
        gt = torch.mm(hi.T, h, out_dtype=torch.float32)
        gt += torch.mm(lo.T, h, out_dtype=torch.float32)
        return gh.to(h.dtype), gt.to(table.dtype)


def _logits_f32(h: Tensor, table: Tensor) -> Tensor:
    """h (B, C, D) against the table (V, D) cast to h's dtype: float32
    logits (B, C, V), as the JAX package's ``preferred_element_type``.  A
    bf16 product on the card accumulates and returns float32; on the CPU the
    bf16 operands are multiplied in float32 (exact products)."""
    b, c, d = h.shape
    table = table.to(h.dtype)
    if h.dtype not in (torch.bfloat16, torch.float16):
        return h @ table.T
    if h.is_cuda:
        return _LogitsF32.apply(h.reshape(b * c, d), table).reshape(b, c, -1)
    return h.float() @ table.float().T


def _xent_chunk(h: Tensor, table: Tensor, labels: Tensor) -> Tensor:
    """Sum over the valid labels (>= 0) of one chunk of lse - gold logit."""
    logits = _logits_f32(h, table)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((lse - gold) * valid)


def chunked_xent(h: Tensor, table: Tensor, labels: Tensor,
                 chunk: int = XENT_CHUNK) -> Tensor:
    """Mean cross-entropy over the labels >= 0 without materializing the
    (B, S, V) logits: sequence chunks of ``chunk`` rows, float32 logits and
    sums; each chunk rematerialized in the backward pass where autograd
    records."""
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[1], chunk):
        args = (h[:, i:i + chunk], table, labels[:, i:i + chunk])
        total = total + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                         if remat else _xent_chunk(*args))
    count = torch.clamp(torch.sum(labels >= 0).to(torch.float32), min=1.0)
    return total / count


def loss_fn(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            dtype=torch.bfloat16):
    """Returns (total, {"loss", "aux_loss"}): the mean next-token
    cross-entropy of ``batch`` (tokens, labels with -1 masks) plus
    ``AUX_LOSS_WEIGHT`` times the auxiliary loss."""
    h, aux, _ = forward(cfg, params, batch, dtype=dtype)
    loss = chunked_xent(h, _logit_table(cfg, params), batch["labels"])
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            max_cache_len: int = 0, dtype=torch.bfloat16):
    """Returns (last-token logits (B,V) f32, caches, pos (B,) int32)."""
    h, _, caches = forward(cfg, params, batch, emit_cache=True,
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
