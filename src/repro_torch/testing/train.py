"""Checks of the LM training path shared by the tests and ``chip_smoke.py``.

``fan_in_scale``: the init draws each stacked weight at std 1/sqrt(groups)
(the JAX package's rule: fan-in is the leading axis), which is 1 for
gemma3-1b's single group, so attention scores are near one-hot and the
gradient is carried by near-ties of the scores: two computations that
round differently give gradients far apart even in float32.  Comparisons
of bf16 gradients, or of two summation orders, draw at std 1/sqrt(fan-in)
instead.

``logits_grad_errors``: the cross-entropy's bf16 logits product held
against float32.  The reference is the float32 product of the same bf16 values, with h a
float32 leaf and the table's rounding passed straight through, so both
gradients are exact float32 sums.  The JAX package's
product (``preferred_element_type=float32``) and its transpose round each
result once, so each of the port's results should be within one bf16
rounding of it: 2^-8 of the largest entry (``ROUNDING``).
"""
from __future__ import annotations

import torch

ROUNDING = 2.0 ** -8       # one rounding to bf16 (8 significant bits)


def fan_in_factors(cfg) -> dict:
    """The factor ``fan_in_scale`` multiplies each leaf by, as a tree of
    floats of the parameters' structure (1.0 where a leaf is left as it
    is), from the specs alone: a caller can scale a tree too large to copy
    in place."""
    from ..models.model import param_specs

    def factor(spec, path, stacked):
        if not stacked or spec.init != "normal" or spec.scale is not None:
            return 1.0
        shape = spec.shape[1:]                  # without the group axis
        if "ffn" in path and len(shape) == 3:   # experts (E, in, out)
            fan = shape[1]
        elif path[-1] in ("wo", "w_o"):
            fan = shape[0] * shape[1]
        else:
            fan = shape[0]
        return (spec.shape[0] / fan) ** 0.5

    def walk(spec, path, stacked):
        if isinstance(spec, dict):
            return {k: walk(spec[k], path + (k,), stacked or k == "groups")
                    for k in spec}
        return factor(spec, path, stacked)
    return walk(param_specs(cfg), (), False)


def fan_in_scale(cfg, params):
    """``params`` (tensors or numpy arrays, as the init draws them) with
    each stacked normal weight (under a ``groups`` key: the layer stack and
    the encoder's) rescaled from std 1/sqrt(groups) to 1/sqrt(its fan-in):
    the first axis after the group axis (d_model for wq, wk, wv, w_gate,
    w_up, the mamba2 and rwkv6 input projections; d_ff for w_down;
    d_inner for mamba2's out_proj), heads x head_dim for wo and rwkv6's
    w_o, and for the MoE experts (E, in, out) the axis after the expert
    axis.  Leaves drawn at a scale of their own (router, LoRA, conv), the
    zeros and ones, and the unstacked leaves (tables, the shared attention
    block) are returned as they are."""
    from ..models.params import tree_map
    return tree_map(lambda p, f: p if f == 1.0 else p * f, params,
                    fan_in_factors(cfg))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def logits_grad_errors(h: torch.Tensor, table: torch.Tensor,
                       gout: torch.Tensor) -> tuple[torch.dtype, list]:
    """``_logits_f32`` of h (B, C, D) rounded to bf16 and the float32 table
    (V, D), and the gradients of sum(logits * gout), against the float32
    reference.  Returns (the logits' dtype, [logits, grad h, grad table]
    as max|error| / max|reference|)."""
    from ..models.model import _logits_f32
    hb = h.to(torch.bfloat16)
    res = []
    for ref in (False, True):
        x = (hb.float() if ref else hb).detach().requires_grad_(True)
        t = table.detach().clone().requires_grad_(True)
        if ref:
            tr = t + (t.to(torch.bfloat16).float() - t).detach()
            out = x @ tr.T
        else:
            out = _logits_f32(x, t)
        (out * gout).sum().backward()
        res.append((out.detach(), x.grad, t.grad))
    return res[0][0].dtype, [_rel(a, b) for a, b in zip(*res)]
