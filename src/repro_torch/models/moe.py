"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.
The port of ``repro.models.moe``.

Each batch row's (token, expert) pairs are sorted by expert id (a stable
sort, as ``jnp.argsort``: which pairs fall past an expert's capacity
depends on that order), clamped to a per-expert capacity, gathered into a
dense (B, E, C, D) block, pushed through per-expert SwiGLU products, and
added back into their tokens with their gate weights.  Dropped pairs
contribute zero from this branch; the residual stream carries their tokens
through, the standard Switch behaviour.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoESpec
from .params import ParamSpec

Tensor = torch.Tensor


def moe_specs(d_model: int, spec: MoESpec) -> dict:
    e, f = spec.n_experts, spec.d_ff
    return {
        "router": ParamSpec((d_model, e), ("embed", None), scale=0.02),
        "w_gate": ParamSpec((e, d_model, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e, d_model, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d_model), ("experts", "mlp", "embed")),
    }


def _capacity(n_tokens: int, spec: MoESpec) -> int:
    c = int(spec.capacity_factor * n_tokens * spec.top_k / spec.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _dispatch_row(logits: Tensor, e: int, k: int, cap: int):
    """Top-k dispatch maps of each batch row (S tokens), all rows at once.

    logits (B, S, E) float32.  Returns (tok_map (B, E*cap) int64 with
    sentinel S, w_map (B, E*cap) float32, aux (B,) float32), the JAX
    function's per-row outputs stacked: the sort, the capacity clamp and
    the scatter stay within a row.
    """
    b, s, _ = logits.shape
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)                          # (b, s, e)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)                # (b, s, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # Switch load-balance auxiliary loss: e * <fraction routed> . <router prob>
    routed = torch.zeros_like(probs).scatter_(-1, gate_idx, 1.0)
    aux = e * torch.sum(routed.mean(1) * probs.mean(1), dim=-1)

    flat_e = gate_idx.reshape(b, s * k)
    flat_w = gate_w.reshape(b, s * k).float()
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k)    # (s*k,)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = flat_tok[order]
    sw = torch.gather(flat_w, 1, order)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    start = torch.searchsorted(se, experts, side="left")            # (b, e)
    pos_in_e = torch.arange(s * k, device=dev) - torch.gather(start, 1, se)
    # dropped pairs go to the sentinel column e*cap, sliced off below
    slot = torch.where(pos_in_e < cap, se * cap + pos_in_e, e * cap)

    tok_map = torch.full((b, e * cap + 1), s, dtype=torch.int64, device=dev)
    tok_map.scatter_(1, slot, stok)
    w_map = torch.zeros((b, e * cap + 1), dtype=torch.float32, device=dev)
    w_map.scatter_(1, slot, sw)
    return tok_map[:, :e * cap], w_map[:, :e * cap], aux


def moe_ffn(params: dict, x: Tensor, spec: MoESpec,
            experts: tuple[int, int] | None = None):
    """x (B, S, D) -> (y (B, S, D), aux_loss float32 scalar).

    The router runs in float32; the expert products in x's dtype.  The
    combine adds each kept pair's weighted output into its token's row of a
    (S + 1, D) buffer per batch row (row S takes the empty slots).  With
    top_k <= 2 a token receives at most two terms, so the sum does not
    depend on the order of the adds.

    ``experts`` (lo, hi): ``params`` holds the weights of experts [lo, hi)
    only (a grid rank's, where the 'experts' axis is on 'model'): the
    router and the dispatch run for every expert, as on the other ranks,
    and the pairs of these experts are gathered, multiplied and combined;
    y is then this rank's part of the sum over the experts.
    """
    dt = x.dtype
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    cap = _capacity(s, spec)

    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    tok_map, w_map, aux = _dispatch_row(logits, e, k, cap)
    aux = aux.mean()
    if experts is not None:
        lo, hi = experts
        tok_map = tok_map[:, lo * cap:hi * cap]
        w_map = w_map[:, lo * cap:hi * cap]
        e = hi - lo

    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)          # sentinel row
    xd = torch.gather(xpad, 1, tok_map[:, :, None].expand(-1, -1, d))
    xd = xd.reshape(b, e, cap, d)

    # ---- per-expert SwiGLU --------------------------------------------------
    g = torch.einsum("becd,edf->becf", xd, params["w_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", xd, params["w_up"].to(dt))
    y = torch.einsum("becf,efd->becd", F.silu(g) * u,
                     params["w_down"].to(dt))

    # ---- combine ------------------------------------------------------------
    yw = y.reshape(b, e * cap, d) * w_map[:, :, None].to(dt)
    rows = tok_map + (s + 1) * torch.arange(b, device=x.device)[:, None]
    out = x.new_zeros((b * (s + 1), d))
    out.index_add_(0, rows.reshape(-1), yw.reshape(b * e * cap, d))
    return out.reshape(b, s + 1, d)[:, :s], aux
