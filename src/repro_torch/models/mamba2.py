"""Mamba2 (SSD) block: the chunked state-space duality algorithm.  The port
of ``repro.models.mamba2``.

Prefill (and training) use the chunked SSD form: within a chunk of Q
tokens everything is dense products; the chunk states are carried by a
loop over the S/Q chunks.  Every decay taken is exp of a non-positive
float32 log, so nothing overflows.  Decode is the O(1) recurrent update.

The JAX function's three-operand einsums are contracted here in an
explicit pairwise order, so no six-axis product is ever formed: at
zamba2-7b's width (H = 112 heads, Q = 256, batch 8 x 2048) the five-axis
(B, nc, Q, Q, H) decay tensor alone is 1.9 GB in float32.

Shapes: d_inner = expand * d_model, H = d_inner // head_dim ssm heads of
head dim P, one state of dim N shared by the heads (ngroups = 1, as in
zamba2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMSpec
from .params import ParamSpec

Tensor = torch.Tensor

_CHUNK = 256


class Mamba2Dims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv_width: int
    conv_dim: int   # channels passing through the causal conv: d_inner + 2N


def mamba2_dims(d_model: int, spec: SSMSpec) -> Mamba2Dims:
    d_inner = spec.expand * d_model
    n_heads = d_inner // spec.head_dim
    return Mamba2Dims(d_inner=d_inner, n_heads=n_heads, head_dim=spec.head_dim,
                      state=spec.state_dim, conv_width=spec.conv_width,
                      conv_dim=d_inner + 2 * spec.state_dim)


def mamba2_specs(d_model: int, spec: SSMSpec) -> dict:
    dims = mamba2_dims(d_model, spec)
    # in_proj -> [z (d_inner), xBC (conv_dim), dt (H)]
    proj_out = dims.d_inner + dims.conv_dim + dims.n_heads
    return {
        "in_proj": ParamSpec((d_model, proj_out), ("embed", "mlp")),
        "conv_w": ParamSpec((dims.conv_width, dims.conv_dim), (None, "mlp"),
                            scale=0.5),
        "conv_b": ParamSpec((dims.conv_dim,), ("mlp",), init="zeros"),
        "a_log": ParamSpec((dims.n_heads,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec((dims.n_heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((dims.n_heads,), ("ssm_heads",), init="ones"),
        "norm_scale": ParamSpec((dims.d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((dims.d_inner, d_model), ("mlp", "embed")),
    }


def _softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` returns x itself past its threshold of 20, which
    differs from it by less than an ulp in float32."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor, state: Tensor | None):
    """Depthwise causal conv1d.  xbc (B,S,C), w (W,C).  state (B,W-1,C) holds
    the trailing context of the previous segment (zeros at the start).
    Returns (silu(conv + b) in xbc's dtype, the new state: the last W-1
    rows of the context, in xbc's dtype)."""
    bsz, s, c = xbc.shape
    width = w.shape[0]
    if state is None:
        state = xbc.new_zeros((bsz, width - 1, c))
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)          # (B, S+W-1, C)
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(width):   # width 4: the taps unrolled, in order
        out = out + full[:, i:i + s].float() * w[i].float()
    out = F.silu(out + b.float()).to(xbc.dtype)
    return out, full[:, s:]


def _whole(t: Tensor) -> Tensor:
    return t


def _gated_rmsnorm(y: Tensor, z: Tensor, scale: Tensor, width: int,
                   total=_whole, eps: float = 1e-5) -> Tensor:
    """RMS norm of y * silu(z) over ``width`` channels, of which y holds
    the ones whose sum of squares ``total`` completes."""
    yf = (y * F.silu(z)).float()
    var = total(torch.sum(yf * yf, dim=-1, keepdim=True)) / width
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssd_chunked(x: Tensor, b_mat: Tensor, c_mat: Tensor, dt: Tensor,
                a: Tensor, h0: Tensor | None = None, chunk: int = _CHUNK):
    """Chunked SSD scan.

    x   (B, S, H, P)   inputs per head
    b_mat, c_mat (B, S, N)  shared input/output projections (ngroups=1)
    dt  (B, S, H)      positive step sizes (softplus already applied)
    a   (H,)           negative per-head decay rates (-exp(a_log))
    h0  (B, H, P, N)   initial state (decode/prefill continuation)
    Returns (y (B,S,H,P) float32, h_final (B,H,P,N) float32).  S must be a
    multiple of min(chunk, S), as in the JAX function.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    xd = (x * dt[..., None]).float()                              # dt-weighted input
    la = a[None, None, :] * dt                                    # (B,S,H) log-decay <= 0
    xc = xd.reshape(bsz, nc, q, h, p)
    bc = b_mat.reshape(bsz, nc, q, n).float()
    cc = c_mat.reshape(bsz, nc, q, n).float()
    lcum = torch.cumsum(la.reshape(bsz, nc, q, h), dim=2)        # inclusive, <= 0

    # intra-chunk: y[t] = sum_{s<=t} (C_t . B_s) exp(L_t - L_s) (x dt)_s,
    # the (C . B) and decay factors multiplied first, then one batched
    # product over s per (batch, chunk, head).  L_t - L_s > 0 above the
    # diagonal may overflow exp, so it is masked to -inf first: no inf is
    # formed and the backward has no 0 * inf (the JAX function takes exp,
    # then masks, and its gradient is NaN wherever such an entry overflows)
    rel = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]         # (B,nc,q,q,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], rel,
                                float("-inf")))
    del rel
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)                  # (B,nc,q,q)
    att = cb[..., None] * dec                                     # (B,nc,q,q,H)
    del dec
    y = torch.einsum("bctsh,bcshp->bcthp", att, xc)
    del att

    # chunk summaries: state_c = sum_s exp(L_end - L_s) B_s (x dt)_s
    dec_end = torch.exp(lcum[:, :, -1:, :] - lcum)                # (B,nc,q,H)
    state_c = torch.einsum("bcsn,bcshp->bchpn", bc,
                           xc * dec_end[..., None])
    gamma = torch.exp(lcum[:, :, -1, :])                          # (B,nc,H) chunk decay

    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0.float())
    hprevs = []                                # the state *before* each chunk
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * gamma[:, c, :, None, None] + state_c[:, c]
    hprev = torch.stack(hprevs, dim=1)                            # (B,nc,H,P,N)

    # inter-chunk: y[t] += exp(L_t) C_t . H_before_chunk
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc, hprev)
    y = y + torch.exp(lcum)[..., None] * y_inter
    return y.reshape(bsz, s, h, p), hstate


def ssd_decode_step(h: Tensor, x: Tensor, b_mat: Tensor, c_mat: Tensor,
                    dt: Tensor, a: Tensor):
    """One-token SSD update.  h (B,H,P,N); x (B,H,P); b,c (B,N); dt (B,H).
    Returns (y (B,H,P), new h), float32."""
    g = torch.exp(a[None, :] * dt)                                # (B,H)
    xd = (x * dt[..., None]).float()
    upd = xd[..., None] * b_mat.float()[:, None, None, :]         # (B,H,P,N)
    hnew = h * g[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", hnew, c_mat.float())
    return y, hnew


def mamba2_block(params: dict, x: Tensor, spec: SSMSpec, *,
                 conv_state: Tensor | None = None,
                 ssm_state: Tensor | None = None, decode: bool = False,
                 heads: tuple[int, int] | None = None, whole=_whole,
                 total=_whole):
    """Apply one Mamba2 block.  x (B,S,Dm) (S == 1 with decode=True).

    Returns (y (B,S,Dm), (new_conv_state, new_ssm_state)): the conv state
    in x's dtype, the ssm state in float32.

    On a grid of ranks (``models.sharded``) a rank runs the ssm heads
    ``heads`` = [lo, hi) with their blocks of ``a_log``, ``dt_bias``,
    ``d_skip``, ``norm_scale``, ``out_proj``'s rows and ``ssm_state``:
    ``whole`` makes ``in_proj``'s output whole (the conv and its state are
    whole), and ``total`` sums the norm's sum of squares and the
    ``out_proj`` product over the ranks.
    """
    dt_ = x.dtype
    dims = mamba2_dims(x.shape[-1], spec)
    bsz, s, _ = x.shape
    lo, hi = heads or (0, dims.n_heads)
    cols = slice(lo * dims.head_dim, hi * dims.head_dim)
    proj = whole(x @ params["in_proj"].to(dt_))
    z, xbc, dtr = torch.split(proj, [dims.d_inner, dims.conv_dim,
                                     dims.n_heads], dim=-1)
    dt = _softplus(dtr[..., lo:hi].float()
                   + params["dt_bias"].float())                   # (B,S,H)
    a = -torch.exp(params["a_log"].float())                       # (H,) < 0
    xbc_f, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   conv_state)
    xs, bm, cm = torch.split(xbc_f, [dims.d_inner, dims.state, dims.state],
                             dim=-1)
    xs = xs[..., cols]

    if decode:
        xh = xs[:, 0].reshape(bsz, hi - lo, dims.head_dim).float()
        if ssm_state is None:
            ssm_state = torch.zeros((bsz, hi - lo, dims.head_dim,
                                     dims.state), dtype=torch.float32,
                                    device=x.device)
        y, h_t = ssd_decode_step(ssm_state, xh, bm[:, 0], cm[:, 0],
                                 dt[:, 0], a)
        y = y + params["d_skip"].float()[None, :, None] * xh
    else:
        xh = xs.reshape(bsz, s, hi - lo, dims.head_dim)
        y, h_t = ssd_chunked(xh, bm, cm, dt, a, h0=ssm_state)
        y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, (hi - lo) * dims.head_dim).to(dt_)
    y = _gated_rmsnorm(y, z[..., cols], params["norm_scale"], dims.d_inner,
                       total)
    return total(y @ params["out_proj"].to(dt_)), (new_conv, h_t)


def mamba2_ref_scan(x: Tensor, b_mat: Tensor, c_mat: Tensor, dt: Tensor,
                    a: Tensor, h0: Tensor | None = None):
    """O(S) sequential oracle for ssd_chunked (tests)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        y, hstate = ssd_decode_step(hstate, x[:, t].float(), b_mat[:, t],
                                    c_mat[:, t], dt[:, t], a)
        ys.append(y)
    return torch.stack(ys, dim=1), hstate
