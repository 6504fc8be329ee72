"""Common layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, positional encodings.

The port of ``repro.models.layers``, function for function: every layer is
``apply(params, x, ...)`` plus a ``*_specs(...)`` builder returning the
ParamSpec tree.  Norms and RoPE compute in float32 and cast back, as the JAX
functions do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .params import ParamSpec

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), (None,), init="ones")}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, D); positions: (B, S) int absolute positions.  Split
    halves, angles in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (D/2,)
    ang = positions.float()[..., None] * freqs                     # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: Tensor, dim: int) -> Tensor:
    """(...,) int -> (..., dim) float32 transformer sinusoids."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp(params: dict, x: Tensor) -> Tensor:
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (F.silu(g) * u) @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_specs(vocab: int, d_model: int) -> dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}


def embed(params: dict, tokens: Tensor, dtype) -> Tensor:
    return params["table"].to(dtype)[tokens]


def unembed(table: Tensor, h: Tensor) -> Tensor:
    """h (..., D) -> logits (..., V) in f32 (table may be the tied embed)."""
    return h.float() @ table.float().T
