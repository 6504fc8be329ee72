"""RWKV6 "Finch": attention-free time mix with a data-dependent per-channel
decay, plus the squared-ReLU channel mix.  The port of
``repro.models.rwkv6``.

The decay w_t = exp(-exp(w0 + lora(x_t))) depends on the input, which makes
the log-space chunked factorization unsafe (exp(-L_s) of an unbounded
cumulative sum), so prefill and training run the recurrence one step at a
time, each step a batched (B,H,D,D) rank-1 update.  Decode is the O(1)
single-step update.

State per layer: wkv (B,H,D,D) float32, plus two token-shift rows (B,Dm)
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..roofline import repeat
from .params import ParamSpec

Tensor = torch.Tensor

_LORA_DIM = 64


def rwkv6_specs(d_model: int, n_heads: int, head_dim: int, d_ff: int) -> dict:
    hd = n_heads * head_dim
    return {
        # time mix
        "mu_r": ParamSpec((d_model,), (None,), init="zeros"),
        "mu_k": ParamSpec((d_model,), (None,), init="zeros"),
        "mu_v": ParamSpec((d_model,), (None,), init="zeros"),
        "mu_g": ParamSpec((d_model,), (None,), init="zeros"),
        "mu_w": ParamSpec((d_model,), (None,), init="zeros"),
        "w_r": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "w_v": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim")),
        "w_g": ParamSpec((d_model, hd), ("embed", "mlp")),
        "w_o": ParamSpec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed")),
        "w0": ParamSpec((n_heads, head_dim), ("heads", "head_dim"), init="zeros"),
        "w_lora_a": ParamSpec((d_model, _LORA_DIM), ("embed", None), scale=0.02),
        "w_lora_b": ParamSpec((_LORA_DIM, n_heads, head_dim), (None, "heads", "head_dim"),
                              scale=0.02),
        "u_bonus": ParamSpec((n_heads, head_dim), ("heads", "head_dim"), init="zeros"),
        "ln_x": ParamSpec((n_heads, head_dim), ("heads", "head_dim"), init="ones"),
        # channel mix
        "mu_ck": ParamSpec((d_model,), (None,), init="zeros"),
        "mu_cr": ParamSpec((d_model,), (None,), init="zeros"),
        "w_ck": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_cv": ParamSpec((d_ff, d_model), ("mlp", "embed")),
        "w_cr": ParamSpec((d_model, d_model), ("embed", None)),
    }


def _shift(x: Tensor, prev: Tensor | None) -> Tensor:
    """Token shift: y[t] = x[t-1]; the first row from the carry (zeros at the
    stream's start).  x (B,S,D); prev (B,D) or None."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _whole(t: Tensor) -> Tensor:
    return t


def _mix(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def wkv_step(state: Tensor, r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
             u: Tensor):
    """One-token update: y = r . (S + diag(u) k v^T), S' = diag(w) S + k v^T.
    state (B,H,D,D); r,k,v,logw (B,H,D).  Returns (y (B,H,D), S')."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    state = torch.exp(logw)[..., :, None] * state + kv
    return y, state


def _wkv_carry(state: Tensor, r: Tensor, k: Tensor, v: Tensor,
               logw: Tensor, u: Tensor):
    """``wkv_step`` as a loop body: (state', y)."""
    y, state = wkv_step(state, r, k, v, logw, u)
    return state, y


def _wkv_chunk(state: Tensor, r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
               u: Tensor):
    """wkv_step over the steps of one chunk: r,k,v,logw (T,B,H,D).
    Returns (final state, y (T,B,H,D)).  The steps are ``roofline.
    repeat``'s loop: a dry run traces one step and scales it."""
    state, ys = repeat(r.shape[0], _wkv_carry, state, r, k, v, logw,
                       consts=(u,))
    return state, torch.stack(ys)


def _wkv_remat(state: Tensor, r: Tensor, k: Tensor, v: Tensor,
               logw: Tensor, u: Tensor):
    """``_wkv_chunk`` rematerialized in the backward pass."""
    return checkpoint(_wkv_chunk, state, r, k, v, logw, u,
                      use_reentrant=False)


def wkv_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
             s0: Tensor | None = None, chunk: int = 64):
    """The RWKV6 recurrence over a sequence.

      y_t   = r_t . (S_{t-1} + diag(u) k_t v_t^T)
      S_t   = diag(w_t) S_{t-1} + k_t v_t^T

    r,k,v (B,S,H,D); logw (B,S,H,D) <= 0; u (H,D); s0 (B,H,D,D).
    Returns (y (B,S,H,D) float32, s_final).

    The steps go in chunks of ``chunk`` (one chunk where S is not a
    multiple of it).  Where autograd records, each chunk is rematerialized
    in the backward pass (``torch.utils.checkpoint``), as the JAX
    function's ``jax.checkpoint`` does, so only the chunk boundaries' states
    are kept.  Chunks and steps are ``roofline.repeat``'s loops: a dry run
    traces one of each and scales it.
    """
    bsz, s, h, d = r.shape
    if s % chunk:
        chunk = s                                 # short sequences: one chunk
    state = (torch.zeros((bsz, h, d, d), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    steps = [a.float().transpose(0, 1) for a in (r, k, v, logw)]  # (S,B,H,D)
    remat = torch.is_grad_enabled()
    # (S/chunk, chunk, B, H, D): chunk c of a step input is its row c
    chunks = [a.view((s // chunk, chunk) + a.shape[1:]) for a in steps]
    state, ys = repeat(s // chunk, _wkv_remat if remat else _wkv_chunk,
                       state, *chunks, consts=(u,))
    return torch.cat(ys).transpose(0, 1), state


def _group_norm(y: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-head layernorm of y (B,S,H,D), with the population variance (as
    ``jnp.var``)."""
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    return (y - mean) * torch.rsqrt(var + eps) * scale[None, None]


def time_mix(params: dict, x: Tensor, *, shift_state: Tensor | None = None,
             wkv_state: Tensor | None = None, decode: bool = False,
             total=_whole):
    """RWKV6 time mix.  x (B,S,Dm).  Returns (y, (new_shift, new_wkv)), the
    states float32.  r, k, v in x's dtype, then float32 into the
    recurrence; the group norm in float32; back to x's dtype before the
    gate.  On a grid of ranks (``models.sharded``) the head leaves and the
    wkv state are a rank's heads' and ``total`` sums the ``w_o`` product
    over the ranks."""
    dt = x.dtype
    bsz = x.shape[0]
    h, d = params["u_bonus"].shape
    xs = _shift(x, shift_state)
    xr = _mix(x, xs, params["mu_r"])
    xk = _mix(x, xs, params["mu_k"])
    xv = _mix(x, xs, params["mu_v"])
    xg = _mix(x, xs, params["mu_g"])
    xw = _mix(x, xs, params["mu_w"])

    r = torch.einsum("bsd,dhe->bshe", xr, params["w_r"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", xk, params["w_k"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", xv, params["w_v"].to(dt))
    g = F.silu(xg @ params["w_g"].to(dt))

    lora = torch.einsum("bsl,lhe->bshe",
                        torch.tanh(xw @ params["w_lora_a"].to(dt)),
                        params["w_lora_b"].to(dt))
    logw = -torch.exp(params["w0"].float()[None, None] + lora.float())

    u = params["u_bonus"].float()
    if decode:
        state = (torch.zeros((bsz, h, d, d), dtype=torch.float32,
                             device=x.device)
                 if wkv_state is None else wkv_state)
        y, new_state = wkv_step(state, r[:, 0].float(), k[:, 0].float(),
                                v[:, 0].float(), logw[:, 0], u)
        y = y[:, None]
    else:
        y, new_state = wkv_scan(r, k, v, logw, u, s0=wkv_state)

    y = _group_norm(y, params["ln_x"].float())
    y = y.reshape(bsz, -1, h * d).to(dt) * g
    y = total(torch.einsum("bshe,hed->bsd", y.reshape(bsz, -1, h, d),
                           params["w_o"].to(dt)))
    return y, (x[:, -1].float(), new_state)


def channel_mix(params: dict, x: Tensor, *, shift_state: Tensor | None = None,
                total=_whole):
    """RWKV channel mix.  Returns (y, new_shift float32).  On a grid of
    ranks (``models.sharded``) ``w_ck``/``w_cv`` are a rank's blocks of an
    MLP and ``total`` sums their product over the ranks before the gate."""
    dt = x.dtype
    xs = _shift(x, shift_state)
    xk = _mix(x, xs, params["mu_ck"])
    xr = _mix(x, xs, params["mu_cr"])
    vv = torch.square(F.relu(xk @ params["w_ck"].to(dt)))
    out = torch.sigmoid(xr @ params["w_cr"].to(dt)) * total(
        vv @ params["w_cv"].to(dt))
    return out, x[:, -1].float()
