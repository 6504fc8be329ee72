"""GQA attention: prefill (query-chunked), decode (one token against a
ring-buffer KV cache) and cross-attention decode (against the source's
keys and values), with causal / sliding-window masks, optional qk-norm and
logit softcap.  The port of ``repro.models.attention``.

Full-sequence attention expands the KV heads to the query heads before the
score product, as the JAX function does, so scores are laid out
(B, H, Sq, T).  Decode goes through the flash-decode op
(``kernels.flash_decode``), which groups the G = H / KV query heads of a kv
head and reads each cache row once: the CUDA kernel on the card, its plain
version on the CPU.

Decode caches are ring buffers: a layer with sliding window W keeps only
min(T, W) cache rows; the new token is written at ``pos % Tc`` and validity is
rebuilt from ``pos`` (all rows valid once the ring has wrapped).  The port
writes the new row into the caller's cache in place (``index_put_``); the
JAX function returns a new cache.

On a (data, model) grid (``models.sharded``) the functions run on one
rank's heads: the head count is ``params["wq"].shape[1]``, and
``kv_heads`` names, by index into the computed kv heads, the ones the local
query heads read where the rank's query heads do not own whole kv heads (one
kv head for the rank, or one a query head): the caches keep every kv head
the rank computes.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_decode import decode_attend_op
from .layers import apply_rope, rmsnorm, rmsnorm_specs
from .params import ParamSpec

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_specs(d_model: int, n_heads: int, n_kv: int, head_dim: int,
               qk_norm: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
    }
    if qk_norm:
        s["q_norm"] = rmsnorm_specs(head_dim)
        s["k_norm"] = rmsnorm_specs(head_dim)
    return s


def _softcap(scores: Tensor, cap: float) -> Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """(B, T, KV, D) -> (B, T, H, D) by repeating each kv head g = H/KV times."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, q_pos: Tensor, k_pos: Tensor,
          causal: bool, window: int, softcap: float,
          k_valid: Tensor | None = None) -> Tensor:
    """q (B,Sq,H,D); k,v (B,T,H,D) already head-expanded; q_pos (B,Sq);
    k_pos (T,) absolute key positions; k_valid (B,T) optional validity mask.
    Scores and softmax in float32; the probabilities are cast to v's dtype
    before the product, as in the JAX function."""
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    scores = scores / math.sqrt(d)
    scores = _softcap(scores, softcap)
    qp = q_pos[:, None, :, None]                       # (B,1,Sq,1)
    kp = k_pos[None, None, None, :]                    # (1,1,1,T)
    allow = torch.ones(scores.shape[-2:], dtype=torch.bool,
                       device=scores.device)[None, None]
    if causal:
        allow = allow & (kp <= qp)
    if window > 0:
        allow = allow & (kp > qp - window)
    if k_valid is not None:
        allow = allow & k_valid[:, None, None, :]
    scores = torch.where(allow, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def multihead_attention(params: dict, x: Tensor, kv_src: Tensor, *,
                        q_pos: Tensor, k_pos: Tensor, causal: bool,
                        window: int = 0, softcap: float = 0.0,
                        qk_norm: bool = False, rope_theta: float = 0.0,
                        q_chunk: int = 512, norm_eps: float = 1e-5,
                        return_kv: bool = False,
                        kv_heads: Tensor | None = None):
    """Full-sequence attention (prefill).

    x (B,S,Dm) queries source; kv_src (B,T,Dm) keys/values source.
    rope_theta == 0 disables RoPE.  Queries go in chunks of ``q_chunk``
    rows, so the scores held at once are (B, H, q_chunk, T).  ``kv_heads``
    (int64 indices into the computed kv heads) picks the kv heads the
    query heads group over; the returned keys and values are all of them.
    """
    dt = x.dtype
    b, s, _ = x.shape
    n_heads = params["wq"].shape[1]

    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k = torch.einsum("btd,dke->btke", kv_src, params["wk"].to(dt))
    v = torch.einsum("btd,dke->btke", kv_src, params["wv"].to(dt))
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k = rmsnorm(params["k_norm"], k, norm_eps)
    if rope_theta:
        q = apply_rope(q, q_pos, rope_theta)
        k = apply_rope(k, k_pos[None, :].expand(b, -1), rope_theta)
    kv = (k, v)
    if kv_heads is not None:
        k, v = k.index_select(2, kv_heads), v.index_select(2, kv_heads)
    kf = _expand_kv(k, n_heads)
    vf = _expand_kv(v, n_heads)

    out = torch.cat([
        _sdpa(q[:, i:i + q_chunk], kf, vf, q_pos=q_pos[:, i:i + q_chunk],
              k_pos=k_pos, causal=causal, window=window, softcap=softcap)
        for i in range(0, s, q_chunk)], dim=1)

    y = torch.einsum("bshe,hed->bsd", out, params["wo"].to(dt))
    if return_kv:
        return y, kv
    return y


def ring_valid(pos: Tensor, tc: int) -> Tensor:
    """(B, Tc) int32 validity of a ring cache once the token at ``pos`` is
    written: rows 0..pos until the ring wraps, then all rows.  Built on
    ``pos``'s device with no host sync."""
    slots = torch.arange(tc, dtype=pos.dtype, device=pos.device)
    return ((slots[None, :] <= pos[:, None]) |
            (pos[:, None] >= tc)).to(torch.int32)


def decode_attention(params: dict, x: Tensor, cache_k: Tensor,
                     cache_v: Tensor, *, pos: Tensor, softcap: float = 0.0,
                     qk_norm: bool = False, rope_theta: float = 0.0,
                     norm_eps: float = 1e-5,
                     kv_heads: Tensor | None = None) -> Tensor:
    """One-token decode against a ring-buffer KV cache.

    x (B,1,Dm); cache_{k,v} (B,Tc,KV,D); pos (B,) absolute position of the new
    token.  Tc == window for sliding-window layers, == max seq for global ones.
    Writes the new key and value into row ``pos % Tc`` of the caches IN PLACE
    and returns y (B,1,Dm).  ``kv_heads`` (int64 indices into the cache's kv
    heads) picks the ones the query heads group over.
    """
    dt = x.dtype
    b = x.shape[0]
    tc = cache_k.shape[1]

    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    k_new = torch.einsum("bsd,dke->bske", x, params["wk"].to(dt))
    v_new = torch.einsum("bsd,dke->bske", x, params["wv"].to(dt))
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k_new = rmsnorm(params["k_norm"], k_new, norm_eps)
    if rope_theta:
        q = apply_rope(q, pos[:, None], rope_theta)
        k_new = apply_rope(k_new, pos[:, None], rope_theta)

    bidx = torch.arange(b, device=pos.device)
    widx = (pos % tc).long()
    cache_k.index_put_((bidx, widx), k_new[:, 0].to(cache_k.dtype))
    cache_v.index_put_((bidx, widx), v_new[:, 0].to(cache_v.dtype))

    if kv_heads is not None:
        cache_k = cache_k.index_select(2, kv_heads)
        cache_v = cache_v.index_select(2, kv_heads)
    # positions are implicit in the rotated keys; ring rows are all in-window
    # by construction, so the mask is pure validity
    out = decode_attend_op(q[:, 0], cache_k, cache_v, ring_valid(pos, tc),
                           softcap=softcap)
    return torch.einsum("bshe,hed->bsd", out[:, None].to(dt),
                        params["wo"].to(dt))


def cross_decode_attention(params: dict, x: Tensor, cross_k: Tensor,
                           cross_v: Tensor, *, softcap: float = 0.0,
                           norm_eps: float = 1e-5,
                           kv_heads: Tensor | None = None) -> Tensor:
    """Decode-time cross-attention against the source's keys and values,
    written by the prefill and only read here.  x (B,1,Dm); cross_{k,v}
    (B,L,KV,D).  Every source row is valid: the flash-decode op over an
    all-ones mask, the JAX function's unmasked softmax.  ``kv_heads`` as
    in ``decode_attention``."""
    dt = x.dtype
    b, l = cross_k.shape[:2]
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(dt))
    if kv_heads is not None:
        cross_k = cross_k.index_select(2, kv_heads)
        cross_v = cross_v.index_select(2, kv_heads)
    valid = torch.ones((b, l), dtype=torch.int32, device=cross_k.device)
    out = decode_attend_op(q[:, 0], cross_k, cross_v, valid, softcap=softcap)
    return torch.einsum("bshe,hed->bsd", out[:, None].to(dt),
                        params["wo"].to(dt))
