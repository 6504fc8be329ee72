"""The LSH family H (paper Def. 5) and WLSH featurization (Def. 6).

h_{w,z}(x)_l = round((x_l - z_l) / w_l) with w_l ~ p(.) iid and
z ~ Unif[0, w], for ``m`` independent instances at once.  A bucket in Z^d is
reduced to two 32-bit universal hashes (key1, key2) and a CountSketch
(slot, sign) pair, exactly as in the JAX package (bitwise).

``featurize`` here is the plain PyTorch version.  The weight is a product
taken in order over d, as the CUDA kernel takes it, so the two agree
bitwise.  The hash runs in int64,
masked to 32 bits after each product and sum, because PyTorch on the CPU has
no ``>>`` and no ``sum`` for uint32; int64 products wrap and the mask keeps
the value mod 2^32.  The float-to-int conversion saturates and maps NaN to
0, as XLA's does.  The CUDA kernel (kernels/featurize) does the same in
native uint32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend import as_tensor
from .bucket_fns import BucketFn

_MASK32 = 0xFFFF_FFFF


class GammaPDF(NamedTuple):
    """p(w) = w^{shape-1} e^{-w/scale} / (Gamma(shape) scale^shape)."""

    shape: float = 2.0
    scale: float = 1.0


class LSHParams(NamedTuple):
    """Parameters of m independent LSH instances over R^d."""

    w: torch.Tensor    # (m, d) float32 bucket widths
    z: torch.Tensor    # (m, d) float32 offsets in [0, w)
    r1: torch.Tensor   # (m, d) uint32 odd hash multipliers (key 1)
    r2: torch.Tensor   # (m, d) uint32 odd hash multipliers (key 2)

    @property
    def m(self) -> int:
        return self.w.shape[0]

    @property
    def d(self) -> int:
        return self.w.shape[1]

    def to(self, device) -> "LSHParams":
        return LSHParams(*(t.to(device) for t in self))


class Features(NamedTuple):
    """Featurization of a point set under m LSH instances.

    ``slot``/``coeff`` (CountSketch slot and weight*sign) are present when
    the featurization was asked for a table size; the index needs only them.
    """

    key1: torch.Tensor    # (m, n) uint32
    key2: torch.Tensor    # (m, n) uint32
    weight: torch.Tensor  # (m, n) float32
    sign: torch.Tensor    # (m, n) float32 in {-1, +1}
    slot: torch.Tensor | None = None   # (m, n) int32 in [0, B)
    coeff: torch.Tensor | None = None  # (m, n) float32


def lsh_params_from_numpy(w, z, r1, r2, device) -> LSHParams:
    """LSHParams on ``device`` from host arrays (r1/r2 as uint32 bits)."""
    def u32(r):
        return torch.from_numpy(np.array(r, np.uint32)).to(device)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return LSHParams(w=f32(w), z=f32(z), r1=u32(r1), r2=u32(r2))


def sample_lsh_params(rng: np.random.Generator, m: int, d: int,
                      pdf: GammaPDF, lengthscale: float = 1.0, *,
                      device="cpu") -> LSHParams:
    """Draw m iid LSH instances on the host from ``rng`` (torch's Gamma
    sampler takes no generator).  ``lengthscale`` folds into w, as hashing
    x/ell with widths w equals widths ell*w."""
    w = (rng.gamma(pdf.shape, 1.0, (m, d)).astype(np.float32)
         * np.float32(pdf.scale) * np.float32(lengthscale))
    z = rng.random((m, d), dtype=np.float32) * w
    imax = np.iinfo(np.int32).max
    r1 = (rng.integers(0, imax, (m, d)).astype(np.uint32) << 1) | 1
    r2 = (rng.integers(0, imax, (m, d)).astype(np.uint32) << 1) | 1
    return lsh_params_from_numpy(w, z, r1, r2, device)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EB_CA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2_AE35) & _MASK32
    return x ^ (x >> 16)


def _to_int32_bits(h: torch.Tensor) -> torch.Tensor:
    """uint32(int32(h)) as int64 in [0, 2^32): saturating, NaN -> 0."""
    hi = h.clamp(-2.0 ** 31, 2.0 ** 31).to(torch.int64)
    hi = hi.clamp(-(2 ** 31), 2 ** 31 - 1)
    hi = torch.where(torch.isnan(h), 0, hi)
    return hi & _MASK32


def _hash(hi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fmix32(sum_d hi_d * r_d mod 2^32) over the last axis, int64 out."""
    prod = (hi * r) & _MASK32
    return _fmix32(prod.sum(dim=-1) & _MASK32)


def featurize_instance(w, z, r1, r2, f: BucketFn, x: torch.Tensor):
    """One instance: (key1, key2, weight, sign) for x (n, d); keys int64."""
    t = (x - z) / w
    h = torch.round(t)
    fu = f(h - t)
    weight = fu[:, 0]
    for c in range(1, fu.shape[1]):      # in order over d, as the kernel
        weight = weight * fu[:, c]
    hi = _to_int32_bits(h)
    key1 = _hash(hi, r1.to(torch.int64))
    key2 = _hash(hi, r2.to(torch.int64))
    sign = 1.0 - 2.0 * (key2 >> 31).to(torch.float32)
    return key1, key2, weight.to(torch.float32), sign


def slots_from_keys(key1: torch.Tensor, table_size: int) -> torch.Tensor:
    """CountSketch slot: low bits of key1 (table_size a power of two)."""
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of 2, got {table_size}")
    return (key1.to(torch.int64) & (table_size - 1)).to(torch.int32)


def featurize(params: LSHParams, f: BucketFn, x: torch.Tensor, *,
              table_size: int = 0) -> Features:
    """Hash + weight a point set x (n, d) under all m instances (plain path).

    Loops over instances so the (n, d) intermediates exist for one instance
    at a time; a whole (m, n, d) block at full size would not fit the card.
    """
    x = as_tensor(x, params.w.device)
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got {tuple(x.shape)}")
    if x.shape[1] != params.d:
        raise ValueError(f"dim mismatch: points {x.shape[1]} vs "
                         f"params {params.d}")
    cols = [featurize_instance(params.w[s], params.z[s], params.r1[s],
                               params.r2[s], f, x) for s in range(params.m)]
    key1, key2, weight, sign = (torch.stack(c) for c in zip(*cols))
    slot = coeff = None
    if table_size:
        slot = slots_from_keys(key1, table_size)
        coeff = weight * sign
    return Features(key1=key1.to(torch.uint32), key2=key2.to(torch.uint32),
                    weight=weight, sign=sign, slot=slot, coeff=coeff)


def slots_from_features(feats: Features, table_size: int) -> torch.Tensor:
    """CountSketch slot per (instance, point)."""
    return slots_from_keys(feats.key1, table_size)
