"""Model assembly: config -> parameter specs -> train / prefill / decode
functions.  The port of ``repro.models.model``.

The layer stack is ``cfg.layer_pattern`` repeated ``cfg.n_groups`` times, with
per-slot parameters stacked on a leading group axis as in the JAX package;
here it is a Python loop over the groups (the JAX package scans them).
Heterogeneous stacks are patterns: gemma3's local:global attention,
zamba2's mamba2 slots with one shared attention block (one parameter set
applied at every third slot), llama-3.2-vision's cross-attention every
fifth slot over image patches, whisper's decoder with cross-attention over
its encoder's states (``_encode``), and the MoE, mamba2 and rwkv6 slots.

Decode state is a tree built from the same ParamSpec machinery as the
parameters: ring-buffer KV caches for attention (see
``models/attention.py``), the shared attention's ring, the cross-attention
source's keys and values (written by the prefill, read only), and the
recurrent states of the mamba2 (conv window, ssm state) and rwkv6 (wkv
state, two token-shift rows) slots.  The recurrent states are float32 and
the conv window is in the compute dtype, as the JAX prefill emits them;
``init_cache`` makes them so.  ``decode_step`` writes every state into the
cache in place.

Training: ``loss_fn`` is the forward plus ``chunked_xent`` plus
``AUX_LOSS_WEIGHT`` times the MoE auxiliary loss, and autograd gives the
gradient.  Where autograd records (``torch.is_grad_enabled()``),
activations are rematerialized as the JAX package's ``jax.checkpoint`` does
(``torch.utils.checkpoint``, non-reentrant): each slot when the pattern's
period is above 4 (gemma3's 26-slot pattern is one group,
llama-3.2-vision's period is 5), else each group; each encoder layer; each
64-step chunk of the rwkv6 recurrence; and each chunk of the cross-entropy,
so one chunk's (B, 512, V) float32 logits is live at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerSpec, ModelConfig
from . import mamba2 as m2
from . import rwkv6 as rw
from .attention import (attn_specs, cross_decode_attention, decode_attention,
                        multihead_attention)
from .layers import (embed_specs, mlp, mlp_specs, rmsnorm, rmsnorm_specs,
                     sinusoidal_positions)
from .moe import moe_ffn, moe_specs
from .params import (ParamSpec, abstract, axes_tree, init_params,
                     stack_specs, tree_map)
from .params import count_params as _count_specs

Tensor = torch.Tensor

AUX_LOSS_WEIGHT = 0.01
XENT_CHUNK = 512
# decode states held in float32 whatever the compute dtype
F32_STATES = frozenset({"ssm", "wkv", "tm_shift", "cm_shift"})


def _use_rope(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"


def cast_params(params: dict, dtype) -> dict:
    """Cast floating params to the compute dtype once, before the layer
    stack (no copy where a tensor already has it)."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


def _shared_window(cfg: ModelConfig) -> int:
    for s in cfg.layer_pattern:
        if s.shared_attn and s.window:
            return s.window
    return 4096


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _slot_specs(cfg: ModelConfig, slot: LayerSpec) -> dict:
    d = cfg.d_model
    s: dict = {"norm1": rmsnorm_specs(d)}
    if slot.kind == "attn":
        s["attn"] = attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               cfg.use_qk_norm)
        s["norm2"] = rmsnorm_specs(d)
        s["ffn"] = moe_specs(d, cfg.moe) if slot.moe else mlp_specs(d, cfg.d_ff)
    elif slot.kind == "mamba2":
        s["mixer"] = m2.mamba2_specs(d, cfg.ssm)
    elif slot.kind == "rwkv6":
        s["mixer"] = rw.rwkv6_specs(d, cfg.n_heads, cfg.head_dim, cfg.d_ff)
        s["norm2"] = rmsnorm_specs(d)
    else:
        raise ValueError(f"unknown slot kind {slot.kind}")
    if slot.cross_attn:
        s["cross_norm"] = rmsnorm_specs(d)
        s["cross_attn"] = attn_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    slots = {f"slot{i}": _slot_specs(cfg, s)
             for i, s in enumerate(cfg.layer_pattern)}
    specs: dict = {
        "embed": embed_specs(cfg.vocab_size, d),
        "groups": stack_specs(slots, cfg.n_groups),
        "final_norm": rmsnorm_specs(d),
    }
    if cfg.has_shared_attn:
        specs["shared"] = {
            "norm": rmsnorm_specs(d),
            "attn": attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        }
    if not cfg.tie_embeddings:
        specs["unembed"] = {"table": ParamSpec((cfg.vocab_size, d),
                                               ("vocab", "embed"), scale=0.02)}
    if cfg.encoder is not None:
        enc_slot = {
            "norm1": rmsnorm_specs(d),
            "attn": attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
            "norm2": rmsnorm_specs(d),
            "ffn": mlp_specs(d, cfg.d_ff),
        }
        specs["encoder"] = {
            "groups": stack_specs({"slot0": enc_slot}, cfg.encoder.n_layers),
            "final_norm": rmsnorm_specs(d),
        }
    return specs


def init(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32):
    """Random parameters on the generator's device."""
    return init_params(param_specs(cfg), generator, dtype)


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    """The parameter tree as meta tensors: shapes and dtype, no storage."""
    return abstract(param_specs(cfg), dtype)


def param_axes(cfg: ModelConfig):
    """The logical axes of every parameter (``repro_torch.sharding``)."""
    return axes_tree(param_specs(cfg))


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _cache_len(seq_len: int, window: int) -> int:
    return seq_len if window == 0 else min(seq_len, window)


def _slot_cache_specs(cfg: ModelConfig, slot: LayerSpec, batch: int,
                      seq_len: int) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    kv_axes = (None, "batch", "seq_shard", "kv_heads", "head_dim")
    c: dict = {}
    if slot.kind == "attn":
        tc = _cache_len(seq_len, slot.window)
        c["k"] = ParamSpec((cfg.n_groups, batch, tc, kv, dh), kv_axes,
                           init="zeros")
        c["v"] = ParamSpec((cfg.n_groups, batch, tc, kv, dh), kv_axes,
                           init="zeros")
    elif slot.kind == "mamba2":
        dims = m2.mamba2_dims(cfg.d_model, cfg.ssm)
        c["conv"] = ParamSpec((cfg.n_groups, batch, dims.conv_width - 1,
                               dims.conv_dim), (None, "batch", None, "mlp"),
                              init="zeros")
        c["ssm"] = ParamSpec((cfg.n_groups, batch, dims.n_heads,
                              dims.head_dim, dims.state),
                             (None, "batch", "ssm_heads", None, None),
                             init="zeros")
    elif slot.kind == "rwkv6":
        c["wkv"] = ParamSpec((cfg.n_groups, batch, cfg.n_heads, cfg.head_dim,
                              cfg.head_dim),
                             (None, "batch", "heads", None, None), init="zeros")
        c["tm_shift"] = ParamSpec((cfg.n_groups, batch, cfg.d_model),
                                  (None, "batch", None), init="zeros")
        c["cm_shift"] = ParamSpec((cfg.n_groups, batch, cfg.d_model),
                                  (None, "batch", None), init="zeros")
    if slot.shared_attn:
        tc = _cache_len(seq_len, _shared_window(cfg))
        c["shared_k"] = ParamSpec((cfg.n_groups, batch, tc, kv, dh), kv_axes,
                                  init="zeros")
        c["shared_v"] = ParamSpec((cfg.n_groups, batch, tc, kv, dh), kv_axes,
                                  init="zeros")
    if slot.cross_attn:
        src_axes = (None, "batch", None, "kv_heads", "head_dim")
        l = cfg.cross_attn_source_len
        c["cross_k"] = ParamSpec((cfg.n_groups, batch, l, kv, dh), src_axes,
                                 init="zeros")
        c["cross_v"] = ParamSpec((cfg.n_groups, batch, l, kv, dh), src_axes,
                                 init="zeros")
    return c


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    return {f"slot{i}": _slot_cache_specs(cfg, s, batch, seq_len)
            for i, s in enumerate(cfg.layer_pattern)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.float32, device=None):
    """Zero decode state: the recurrent states (``F32_STATES``) in float32,
    the rest in ``dtype``."""
    return {slot: {name: torch.zeros(
        s.shape, dtype=torch.float32 if name in F32_STATES else dtype,
        device=device) for name, s in specs.items()}
        for slot, specs in cache_specs(cfg, batch, seq_len).items()}


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   dtype=torch.float32):
    """``init_cache``'s tree as meta tensors (the recurrent states float32,
    as there)."""
    return init_cache(cfg, batch, seq_len, dtype, device="meta")


def cache_axes(cfg: ModelConfig, batch: int, seq_len: int):
    """The logical axes of every decode-cache leaf."""
    return axes_tree(cache_specs(cfg, batch, seq_len))


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
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
                     *, positions: Tensor, k_pos: Tensor,
                     cross_src: Tensor | None, shared_params: dict | None,
                     causal: bool, emit_cache: bool, cache_len: int):
    """One pattern slot over a full sequence.  Returns (x, cache_dict, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: dict = {}
    rope = cfg.rope_theta if _use_rope(cfg) else 0.0
    if slot.kind == "attn":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        y, (k, v) = multihead_attention(
            sp["attn"], h, h, q_pos=positions, k_pos=k_pos, causal=causal,
            window=slot.window, softcap=cfg.attn_logit_softcap,
            qk_norm=cfg.use_qk_norm, rope_theta=rope, norm_eps=cfg.norm_eps,
            return_kv=True)
        x = x + y
        if emit_cache:
            tc = _cache_len(cache_len, slot.window)
            cache["k"] = _ring_from_prefill(k, tc)
            cache["v"] = _ring_from_prefill(v, tc)
    elif slot.kind == "mamba2":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        y, (conv_st, ssm_st) = m2.mamba2_block(sp["mixer"], h, cfg.ssm)
        x = x + y
        if emit_cache:
            cache["conv"], cache["ssm"] = conv_st, ssm_st
    elif slot.kind == "rwkv6":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        y, (tm_shift, wkv_st) = rw.time_mix(sp["mixer"], h)
        x = x + y
        h2 = rmsnorm(sp["norm2"], x, cfg.norm_eps)
        y2, cm_shift = rw.channel_mix(sp["mixer"], h2)
        x = x + y2
        if emit_cache:
            cache["wkv"], cache["tm_shift"], cache["cm_shift"] = \
                wkv_st, tm_shift, cm_shift

    if slot.shared_attn:
        h = rmsnorm(shared_params["norm"], x, cfg.norm_eps)
        win = _shared_window(cfg)
        y, (k, v) = multihead_attention(
            shared_params["attn"], h, h, q_pos=positions, k_pos=k_pos,
            causal=causal, window=win, rope_theta=rope, norm_eps=cfg.norm_eps,
            return_kv=True)
        x = x + y
        if emit_cache:
            tc = _cache_len(cache_len, win)
            cache["shared_k"] = _ring_from_prefill(k, tc)
            cache["shared_v"] = _ring_from_prefill(v, tc)

    if slot.cross_attn:
        h = rmsnorm(sp["cross_norm"], x, cfg.norm_eps)
        l = cross_src.shape[1]
        y, (ck, cv) = multihead_attention(
            sp["cross_attn"], h, cross_src, q_pos=positions,
            k_pos=torch.arange(l, dtype=torch.int32, device=x.device),
            causal=False, rope_theta=0.0, norm_eps=cfg.norm_eps,
            return_kv=True)
        x = x + y
        if emit_cache:
            cache["cross_k"], cache["cross_v"] = ck, cv

    if slot.kind == "attn":
        h = rmsnorm(sp["norm2"], x, cfg.norm_eps)
        if slot.moe:
            y, a = moe_ffn(sp["ffn"], h, cfg.moe)
            aux = aux + a
        else:
            y = mlp(sp["ffn"], h)
        x = x + y
    return x, cache, aux


def _group(tree: dict, g: int) -> dict:
    """The params (or caches) of layer group ``g``: views, no copies."""
    return tree_map(lambda p: p[g], tree)


def _backbone_full(cfg: ModelConfig, params: dict, h: Tensor,
                   positions: Tensor, *, cross_src: Tensor | None,
                   causal: bool, emit_cache: bool, cache_len: int):
    """The pattern groups over a full sequence, one after the other.
    Returns (hidden, aux summed over slots and groups, caches stacked on the
    group axis or None).  Each group's caches are copied into the stacked
    tree as the group ends, so the stack is never held twice.  Where
    autograd records, each slot (period > 4) or each group is
    rematerialized in the backward pass."""
    k_pos = torch.arange(h.shape[1], dtype=positions.dtype, device=h.device)
    shared = params.get("shared")
    remat = torch.is_grad_enabled()
    remat_slots = cfg.period > 4

    def slot_fn(slot, sp, x):
        return _apply_slot_full(cfg, slot, sp, x, positions=positions,
                                k_pos=k_pos, cross_src=cross_src,
                                shared_params=shared, causal=causal,
                                emit_cache=emit_cache, cache_len=cache_len)

    def group_fn(gp, x, slot_remat):
        caches = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, slot in enumerate(cfg.layer_pattern):
            if slot_remat:
                x, caches[f"slot{i}"], a = checkpoint(
                    slot_fn, slot, gp[f"slot{i}"], x, use_reentrant=False)
            else:
                x, caches[f"slot{i}"], a = slot_fn(slot, gp[f"slot{i}"], x)
            aux = aux + a
        return x, caches, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    stacked = None
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        if remat and not remat_slots:
            h, caches, a = checkpoint(group_fn, gp, h, False,
                                      use_reentrant=False)
        else:
            h, caches, a = group_fn(gp, h, remat)
        aux = aux + a
        if emit_cache:
            if stacked is None:
                stacked = tree_map(lambda c: c.new_empty(
                    (cfg.n_groups,) + tuple(c.shape)), caches)
            tree_map(lambda dst, c: dst[g].copy_(c), stacked, caches)
        del caches
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, aux, stacked


def _encode(cfg: ModelConfig, params: dict, frames: Tensor) -> Tensor:
    """Whisper-style bidirectional encoder over precomputed frame
    embeddings (B, L, Dm), sinusoidal positions added; each layer
    rematerialized where autograd records."""
    enc = params["encoder"]
    b, l, _ = frames.shape
    pos = torch.arange(l, dtype=torch.int32, device=frames.device)
    h = frames + sinusoidal_positions(pos, cfg.d_model)[None].to(frames.dtype)

    def layer(sp, x):
        hn = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        x = x + multihead_attention(
            sp["attn"], hn, hn, q_pos=pos[None].expand(b, -1), k_pos=pos,
            causal=False, rope_theta=0.0, norm_eps=cfg.norm_eps)
        return x + mlp(sp["ffn"], rmsnorm(sp["norm2"], x, cfg.norm_eps))

    remat = torch.is_grad_enabled()
    for g in range(cfg.encoder.n_layers):
        sp = _group(enc["groups"], g)["slot0"]
        h = (checkpoint(layer, sp, h, use_reentrant=False) if remat
             else layer(sp, h))
    return rmsnorm(enc["final_norm"], h, cfg.norm_eps)


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: Tensor,
                  positions: Tensor, dtype) -> Tensor:
    h = params["embed"]["table"].to(dtype)[tokens]
    if not _use_rope(cfg):
        h = h + sinusoidal_positions(positions, cfg.d_model).to(dtype)
    return h


def _cross_source(cfg: ModelConfig, params: dict, batch: dict[str, Tensor],
                  dtype) -> Tensor | None:
    """The cross-attention source: the encoder's states over ``frames``
    (whisper), the image ``patches`` as given (VLM), or None."""
    if cfg.encoder is not None:
        return _encode(cfg, params, batch["frames"].to(dtype))
    if cfg.cross_attn_source_len:
        return batch["patches"].to(dtype)
    return None


def forward(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            emit_cache: bool = False, max_cache_len: int = 0,
            dtype=torch.bfloat16, mesh=None):
    """Full-sequence forward.  Returns (hidden (B,S,D), aux, caches); aux is
    the MoE auxiliary loss summed over slots and groups, a float32 scalar
    (zero without MoE slots).  ``batch`` holds ``tokens`` and, for whisper,
    ``frames`` (B, n_frames, D), for a VLM ``patches`` (B, L, D).

    ``max_cache_len`` sizes the emitted decode caches (>= prompt length +
    planned decode steps); defaults to the prompt length.

    With ``mesh`` (a ``launch.mesh.Mesh``) the forward runs on that grid of
    ranks (``models.sharded``): ``params`` are this rank's blocks, the
    batch is global, and the hidden rows and caches this rank's.
    """
    if mesh is not None:
        from . import sharded
        return sharded.forward(sharded.GridLayout(cfg, mesh), params, batch,
                               emit_cache=emit_cache,
                               max_cache_len=max_cache_len, dtype=dtype)
    tokens = batch["tokens"]
    params = cast_params(params, dtype)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, -1)
    h = _embed_tokens(cfg, params, tokens, positions, dtype)
    cross_src = _cross_source(cfg, params, batch, dtype)
    return _backbone_full(cfg, params, h, positions, cross_src=cross_src,
                          causal=True, emit_cache=emit_cache,
                          cache_len=max(max_cache_len, s))


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
    bf16 product on the card (and on meta tensors, which stand for it in a
    dry run) accumulates and returns float32; on the CPU the bf16 operands
    are multiplied in float32 (exact products)."""
    b, c, d = h.shape
    table = table.to(h.dtype)
    if h.dtype not in (torch.bfloat16, torch.float16):
        return h @ table.T
    if h.is_cuda or h.is_meta:
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
            dtype=torch.bfloat16, mesh=None):
    """Returns (total, {"loss", "aux_loss"}): the mean next-token
    cross-entropy of ``batch`` (tokens, labels with -1 masks) plus
    ``AUX_LOSS_WEIGHT`` times the auxiliary loss.  With ``mesh``, on that
    grid (``models.sharded.loss_fn``): this rank's parameter blocks and the
    global batch in, the global loss and aux out on every rank, ``total``'s
    backward the rank's share of the gradient."""
    if mesh is not None:
        from . import sharded
        return sharded.loss_fn(sharded.GridLayout(cfg, mesh), params, batch,
                               dtype=dtype)
    h, aux, _ = forward(cfg, params, batch, dtype=dtype)
    loss = chunked_xent(h, _logit_table(cfg, params), batch["labels"])
    total = loss + AUX_LOSS_WEIGHT * aux
    return total, {"loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: dict, batch: dict[str, Tensor], *,
            max_cache_len: int = 0, dtype=torch.bfloat16, mesh=None):
    """Returns (last-token logits (B,V) f32, caches, pos (B,) int32).  With
    ``mesh``, on that grid (``models.sharded.prefill``): this rank's
    blocks of the parameters and the global batch in; its rows' logits over
    its vocab range, its cache blocks and its rows' positions out."""
    if mesh is not None:
        from . import sharded
        return sharded.prefill(sharded.GridLayout(cfg, mesh), params, batch,
                               max_cache_len=max_cache_len, dtype=dtype)
    h, _, caches = forward(cfg, params, batch, emit_cache=True,
                           max_cache_len=max_cache_len, dtype=dtype)
    logits = h[:, -1].float() @ _logit_table(cfg, params).float().T
    b, s = batch["tokens"].shape
    return logits, caches, torch.full((b,), s, dtype=torch.int32,
                                      device=h.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _apply_slot_decode(cfg: ModelConfig, slot: LayerSpec, sp: dict,
                       x: Tensor, *, pos: Tensor, cache: dict,
                       shared_params: dict | None) -> Tensor:
    """One pattern slot for one token.  Returns x; every state of the
    slot's ``cache`` (views into the group's cache) is updated IN PLACE,
    the cross-attention keys and values only read."""
    rope = cfg.rope_theta if _use_rope(cfg) else 0.0
    if slot.kind == "attn":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        x = x + decode_attention(sp["attn"], h, cache["k"], cache["v"],
                                 pos=pos, softcap=cfg.attn_logit_softcap,
                                 qk_norm=cfg.use_qk_norm, rope_theta=rope,
                                 norm_eps=cfg.norm_eps)
    elif slot.kind == "mamba2":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        y, (conv_st, ssm_st) = m2.mamba2_block(
            sp["mixer"], h, cfg.ssm, conv_state=cache["conv"],
            ssm_state=cache["ssm"], decode=True)
        x = x + y
        cache["conv"].copy_(conv_st)
        cache["ssm"].copy_(ssm_st)
    elif slot.kind == "rwkv6":
        h = rmsnorm(sp["norm1"], x, cfg.norm_eps)
        y, (tm_shift, wkv_st) = rw.time_mix(
            sp["mixer"], h, shift_state=cache["tm_shift"],
            wkv_state=cache["wkv"], decode=True)
        x = x + y
        h2 = rmsnorm(sp["norm2"], x, cfg.norm_eps)
        y2, cm_shift = rw.channel_mix(sp["mixer"], h2,
                                      shift_state=cache["cm_shift"])
        x = x + y2
        cache["wkv"].copy_(wkv_st)
        cache["tm_shift"].copy_(tm_shift)
        cache["cm_shift"].copy_(cm_shift)

    if slot.shared_attn:
        h = rmsnorm(shared_params["norm"], x, cfg.norm_eps)
        x = x + decode_attention(shared_params["attn"], h, cache["shared_k"],
                                 cache["shared_v"], pos=pos, rope_theta=rope,
                                 norm_eps=cfg.norm_eps)

    if slot.cross_attn:
        h = rmsnorm(sp["cross_norm"], x, cfg.norm_eps)
        x = x + cross_decode_attention(sp["cross_attn"], h, cache["cross_k"],
                                       cache["cross_v"], norm_eps=cfg.norm_eps)

    if slot.kind == "attn":
        h = rmsnorm(sp["norm2"], x, cfg.norm_eps)
        x = x + (moe_ffn(sp["ffn"], h, cfg.moe)[0] if slot.moe
                 else mlp(sp["ffn"], h))
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: Tensor,
                pos: Tensor, *, dtype=torch.bfloat16, mesh=None):
    """One serving step: tokens (B,1) int, pos (B,) absolute positions.
    Returns (logits (B,V) f32, cache).  The cache is updated IN PLACE (the
    new token's keys and values written into their ring rows, the recurrent
    states overwritten) and returned as the same object; clone it first to
    keep the old state.  With ``mesh``, on that grid
    (``models.sharded.decode_step``): this rank's parameter blocks, its
    ``ShardedCache`` from the grid's prefill and its rows' tokens and
    positions."""
    if mesh is not None:
        from . import sharded
        return sharded.decode_step(sharded.GridLayout(cfg, mesh), params,
                                   cache, tokens, pos, dtype=dtype)
    params = cast_params(params, dtype)
    h = _embed_tokens(cfg, params, tokens, pos[:, None], dtype)
    shared = params.get("shared")
    for g in range(cfg.n_groups):
        gp, gc = _group(params["groups"], g), _group(cache, g)
        for i, slot in enumerate(cfg.layer_pattern):
            h = _apply_slot_decode(cfg, slot, gp[f"slot{i}"], h, pos=pos,
                                   cache=gc[f"slot{i}"],
                                   shared_params=shared)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = h[:, 0].float() @ _logit_table(cfg, params).float().T
    return logits, cache


def count_params(cfg: ModelConfig) -> int:
    return _count_specs(param_specs(cfg))
