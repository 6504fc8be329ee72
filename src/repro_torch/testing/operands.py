"""Edge operands of the featurize kernel: the inputs where its fast divide
and rounding hand over to the exact path, or where rounding is closest to a
tie, and divide operands whose quotient lies next to a midpoint of two
float32s.  Shared by the CPU model tests, the card tests and
``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
TINY, HUGE = np.finfo(_F32).tiny, np.finfo(_F32).max


def _up(v):
    return np.nextafter(_F32(v), _F32(np.inf))


def _down(v):
    return np.nextafter(_F32(v), _F32(-np.inf))


def featurize_edge_case(seed: int, n: int, d: int, m: int):
    """(x (n, d), w, z (m, d) float32, r1, r2 (m, d) uint32).  Instance 0
    has w = 1, z = 0 on its first coordinates, so t = x there; instances 1
    and 2 widths at and past the fast path's 2^-60 and 2^60, near the
    smallest normal and near FLT_MAX; the last instance w = 1e-4 (|t| past
    2^31).  Point rows: 0-7 scaled by 1e6, 8-15 half-integers, then NaN,
    +-inf, a subnormal, |t| at 2^22, 2^23 and 2^31, k + 1/2 +- 1 ulp, 2^22
    and 2^23 +- 1 ulp, 3e38.  Needs n >= 25, d >= 4, m >= 3."""
    if n < 25 or d < 4 or m < 3:
        raise ValueError(f"need n >= 25, d >= 4, m >= 3; got {n}, {d}, {m}")
    rng = np.random.default_rng(seed)
    w = rng.gamma(2.0, 1.0, (m, d)).astype(_F32)
    z = (rng.random((m, d)) * w).astype(_F32)
    w[0, :4], z[0, :4] = 1.0, 0.0
    w[1, :4] = (2.0 ** -61, 2.0 ** 61, 2.0 ** -60, 2.0 ** 60)
    w[2, :4] = (1.5 * TINY, HUGE / 2, _down(2.0 ** -60), _up(2.0 ** 60))
    w[-1, -2:] = 1e-4
    r1 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r2 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r1[:, 0] = r2[:, 0] = np.uint32(2 ** 32 - 1)
    x = (rng.random((n, d), dtype=_F32) * 4.0 - 2.0)
    x[:8] *= _F32(1e6)
    x[8:16] = (np.arange(8, dtype=_F32) - 3.5)[:, None]
    x[16, 0], x[17, 1], x[18, 2] = np.nan, np.inf, -np.inf
    x[19] = 1e-40
    x[20, :4] = (2.0 ** 22 - 0.5, 2.0 ** 22, 2.0 ** 23 - 1.5, 2.0 ** 31)
    x[21, :4] = -x[20, :4]
    x[22, :4] = (_up(2.5), _down(2.5), _down(-7.5), _up(-7.5))
    x[23, :4] = (_down(2.0 ** 22), _up(2.0 ** 22), _down(2.0 ** 23),
                 _up(2.0 ** 23))
    x[24] = 3e38
    return x, w, z, r1, r2


def tie_adjacent_quotients(sig: torch.Tensor):
    """(a, w) float32 pairs, both in [1, 2), whose quotient a / w lies next
    to a midpoint of two float32s, where rounding the quotient is hardest:
    for each w significand W in ``sig`` (int64, in [2^23, 2^24); w = W
    2^-23), the a with A 2^s = W M + c, where M is the odd 25-bit
    significand of a midpoint, s is 24 or 25 (a's significand above or below
    w's), and c = c0 2^k, with k the trailing zero bits of W and c0 in +-1,
    +-3, +-5.  Then a / w = M 2^-s + c / (W 2^s): within 5 / (Wo 2^24) of
    the midpoint, Wo = W 2^-k, a few times the least distance a quotient by
    this w can keep from one.  About 5.6 pairs per W, on ``sig``'s
    device."""
    W = sig.to(torch.int64)
    low = W & -W                                   # the lowest set bit
    k = torch.log2(low.double()).round().to(torch.int64)
    Wo = W >> k
    inv = Wo.clone()                               # Wo^-1 mod 8, then Newton
    for _ in range(4):                             # 3 -> 48 bits
        inv = (inv * ((2 - Wo * inv) & 0x1FFFFFF)) & 0x1FFFFFF
    a_out, w_out = [], []
    for s in (24, 25):
        mod = torch.bitwise_left_shift(torch.ones_like(k), s - k)
        for c0 in (1, -1, 3, -3, 5, -5):
            res = torch.remainder(-c0 * inv, mod)
            M = res + (((1 << 24) - res + mod - 1) // mod) * mod
            num = W * M + c0 * (low)
            A = num >> s
            ok = (M < (1 << 25)) & (A >= (1 << 23)) & (A < (1 << 24))
            a_out.append(A[ok].to(torch.float32) * 2.0 ** -23)
            w_out.append(W[ok].to(torch.float32) * 2.0 ** -23)
    return torch.cat(a_out), torch.cat(w_out)
