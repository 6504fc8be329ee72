"""WLSH kernel attention: the paper's estimator as a sub-quadratic attention
layer.  The port of ``repro.models.wlsh_attention`` (beyond the paper).

Softmax attention is replaced by shift-invariant kernel attention

    out_i = sum_j k(zq_i - zk_j) v_j / sum_j k(zq_i - zk_j)

with k the WLSH kernel (Def. 8) estimated by the bucket-load trick over
values: per LSH instance, keys deposit (weight_j * v_j, weight_j) into
their bucket, and each query reads its own bucket back, O(S m) instead of
O(S^2).  Queries and keys are first projected to a low hash dimension, the
projection part of each instance's randomness.

Bidirectional (encoder) form only, as in the JAX package.  No entry point
of either package runs it; ``kernel_attention_oracle`` is the explicit
O(S^2) check with the analytic kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend import resolve_device
from ..core.bucket_fns import BucketFn
from ..core.lsh import GammaPDF, _hash, _to_int32_bits

Tensor = torch.Tensor


class WLSHAttnParams(NamedTuple):
    proj: Tensor   # (m, D, dh) float32 random projections to hash space
    w: Tensor      # (m, dh) float32 bucket widths ~ p(.)
    z: Tensor      # (m, dh) float32 offsets ~ Unif[0, w]
    r1: Tensor     # (m, dh) uint32 universal hash keys (odd)


def wlsh_attn_params_from_numpy(proj, w, z, r1, device) -> WLSHAttnParams:
    """WLSHAttnParams on ``device`` from host arrays (r1 as uint32 bits)."""
    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return WLSHAttnParams(proj=f32(proj), w=f32(w), z=f32(z),
                          r1=torch.from_numpy(np.array(r1, np.uint32)).to(
                              device))


def sample_wlsh_attn(rng: np.random.Generator, m: int, d_head: int, *,
                     d_hash: int = 4, pdf: GammaPDF = GammaPDF(2.0, 1.0),
                     lengthscale: float = 1.0,
                     device=None) -> WLSHAttnParams:
    """Draw m instances on the host from ``rng`` and put them on ``device``
    (None: the card, raising without one), as ``core.lsh.sample_lsh_params``
    does.  The draws differ from the JAX package's ``jax.random`` ones:
    tests give both packages the same arrays."""
    device = resolve_device(device)
    proj = rng.standard_normal((m, d_head, d_hash)) / np.sqrt(d_head)
    w = (rng.gamma(pdf.shape, 1.0, (m, d_hash)).astype(np.float32)
         * np.float32(pdf.scale) * np.float32(lengthscale))
    z = rng.random((m, d_hash), dtype=np.float32) * w
    imax = np.iinfo(np.int32).max
    r1 = (rng.integers(0, imax, (m, d_hash)).astype(np.uint32) << 1) | 1
    return wlsh_attn_params_from_numpy(proj, w, z, r1, device)


def _hash_weight(x: Tensor, params: WLSHAttnParams, f: BucketFn,
                 table_size: int):
    """x (..., S, D) -> (slot (m, ..., S) int64, weight (m, ..., S) f32).
    The hash is ``core.lsh``'s key 1: int64 holding uint32 values, masked
    to 32 bits after each product and the sum."""
    zx = torch.einsum("...sd,mdh->m...sh", x.float(), params.proj)
    shape = (params.w.shape[0],) + (1,) * (zx.ndim - 2) + params.w.shape[1:]
    t = (zx - params.z.reshape(shape)) / params.w.reshape(shape)
    h = torch.round(t)
    weight = torch.prod(f(h - t), dim=-1)
    key1 = _hash(_to_int32_bits(h), params.r1.reshape(shape).to(torch.int64))
    return key1 & (table_size - 1), weight


def wlsh_attention(q: Tensor, k: Tensor, v: Tensor, params: WLSHAttnParams,
                   f: BucketFn, *, table_size: int = 1024,
                   eps: float = 1e-6) -> Tensor:
    """Bidirectional WLSH kernel attention.

    q, k (B, S, H, D); v (B, S, H, Dv) -> (B, S, H, Dv) in v's dtype.  Cost
    O(B H S m Dv) against softmax's O(B H S^2 Dv).
    """
    b, s, nh, dv = v.shape
    if table_size & (table_size - 1):
        raise ValueError("table_size must be a power of two")
    # merge batch and head; hash queries and keys under the same instances
    qf = q.transpose(1, 2).reshape(b * nh, s, q.shape[-1])
    kf = k.transpose(1, 2).reshape(b * nh, s, k.shape[-1])
    vf = v.transpose(1, 2).reshape(b * nh, s, dv).float()

    slot_q, w_q = _hash_weight(qf, params, f, table_size)   # (m, BH, S)
    slot_k, w_k = _hash_weight(kf, params, f, table_size)

    m = slot_q.shape[0]
    bh = b * nh
    # bucket loads over keys: values and normalizer in one table
    vals1 = torch.cat([vf, vf.new_ones((bh, s, 1))], dim=-1)
    contrib = w_k[..., None] * vals1[None]                  # (m, BH, S, Dv+1)
    base = (torch.arange(m * bh, device=v.device) * table_size).reshape(
        m, bh, 1)
    tables = vf.new_zeros((m * bh * table_size, dv + 1))
    tables.index_add_(0, (base + slot_k).reshape(-1),
                      contrib.reshape(-1, dv + 1))
    # query readout: each query reads its own bucket, scaled by its weight
    read = tables[(base + slot_q).reshape(-1)].reshape(m, bh, s, dv + 1)
    acc = torch.sum(read * w_q[..., None], dim=0)           # over instances
    out = acc[..., :dv] / torch.clamp(acc[..., dv:], min=eps * m)
    return out.reshape(b, nh, s, dv).transpose(1, 2).to(v.dtype)


def kernel_attention_oracle(q: Tensor, k: Tensor, v: Tensor, kernel_1d,
                            params: WLSHAttnParams,
                            eps: float = 1e-6) -> Tensor:
    """Explicit O(S^2) kernel attention with the analytic expected kernel
    ``kernel_1d``, averaged over the projection instances (tests)."""
    zq = torch.einsum("bshd,mde->mbshe", q.float(), params.proj)
    zk = torch.einsum("bshd,mde->mbshe", k.float(), params.proj)
    diff = zq[:, :, :, None] - zk[:, :, None, :]            # (m,B,Sq,Sk,H,e)
    kmat = torch.mean(torch.prod(kernel_1d(diff), dim=-1), dim=0)
    num = torch.einsum("bqkh,bkhd->bqhd", kmat, v.float())
    den = torch.sum(kmat, dim=2)[..., None]
    return num / torch.clamp(den, min=eps)
