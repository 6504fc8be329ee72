"""Plain WLSH-KRR (the paper's Defs. 5-6 with a CountSketch table, and
§4.2's solve), written from the definitions in plain PyTorch.

* ``features``: for every instance s and point i, the bucket
  h = round((x - z_s) / w_s) in Z^d, its weight prod_l f(h_l - t_l), two
  32-bit hashes of h (sum_l h_l r_l mod 2^32 through murmur3's finalizer),
  the sign from key 2's top bit and the slot from key 1's low bits.  Returns
  the flat table index s * B + slot and coeff = weight * sign.
* ``matvec``: K~ v = (1/m) sum_s C_s C_s^T v with C_s the signed
  CountSketch of instance s: ``index_add_`` into the tables, then a gather.
* ``pcg``: conjugate gradients on (K~ + lam I) beta = y from beta = 0,
  stopping when ||r|| <= max(tol ||y||, atol) or after ``maxiter``.
* ``loads`` / ``predict``: the (m, B) tables of beta, and the mean over
  the instances of coeff times the table entry of each query.

``dtype`` is the storage type of every value the solve and the readout
hold (coefficients, vectors, tables, predictions); sums over the points
and the instances run in float32.  float32 is the configuration's
precision; bfloat16 is the lower-precision control.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFF_FFFF
BLOCK_ELEMS = 1 << 25      # (instance, point, dimension) triples a block


def _smooth_const() -> float:
    # f(x) = c G(2x), G = rect * rect_{1/4} * rect_{1/4}; c = 1/||G(2.)||_2,
    # ||G(2.)||^2 = int_0^{3/4} G(t)^2 dt, integrated piece by piece
    a = (1 / 16) ** 2 * 0.25
    # int_{1/4}^{1/2} (-t^2/2 + t/4 + 1/32)^2 dt, by Simpson's rule, exact
    # for a quartic
    g = lambda t: (-0.5 * t * t + 0.25 * t + 1 / 32) ** 2
    b = (0.25 / 6) * (g(0.25) + 4 * g(0.375) + g(0.5))
    c = (0.5 * 0.25 ** 2) ** 2 * 0.25 / 5   # int_0^{1/4} (s^2/2)^2 ds
    return 1.0 / math.sqrt(a + b + c)


def bucket_value(name: str, u: torch.Tensor) -> torch.Tensor:
    """f(u) of the named bucket function (even, supported on [-1/2, 1/2],
    unit L2 norm)."""
    au = u.abs()
    inside = au <= 0.5
    if name == "rect":
        return inside.to(torch.float32)
    if name == "tent":
        return torch.where(inside, math.sqrt(3.0) * (1 - 2 * au), 0.0)
    if name == "smooth":
        t = 2 * au
        g = torch.where(t <= 0.25, torch.full_like(t, 1 / 16), torch.where(
            t <= 0.5, -0.5 * t * t + 0.25 * t + 1 / 32,
            torch.where(t <= 0.75, 0.5 * (0.75 - t) ** 2, 0.0)))
        return _smooth_const() * g
    raise ValueError(f"unknown bucket function {name!r}")


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EB_CA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2_AE35) & MASK32
    return h ^ (h >> 16)


def _key(hi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fmix32(sum_l hi_l r_l mod 2^32) over the last axis (int64 holding
    uint32 values; the products wrap mod 2^64, the mask keeps mod 2^32)."""
    return _fmix32(((hi * r) & MASK32).sum(-1) & MASK32)


def features(x: torch.Tensor, lsh: dict, bucket: str, table_size: int):
    """(idx, coeff) of the points x (n, d) under the m instances of ``lsh``
    (w, z float32 (m, d); r1, r2 int64 holding odd uint32 values): idx
    (m, n) int64 is s * B + slot, coeff (m, n) float32 weight * sign."""
    w, z, r1, r2 = lsh["w"], lsh["z"], lsh["r1"], lsh["r2"]
    m, d = w.shape
    n = x.shape[0]
    idx = torch.empty((m, n), dtype=torch.int64, device=x.device)
    coeff = torch.empty((m, n), dtype=torch.float32, device=x.device)
    rows = max(1, BLOCK_ELEMS // (m * d))
    base = (torch.arange(m, device=x.device) * table_size)[:, None]
    for i in range(0, n, rows):
        xb = x[i:i + rows]
        t = (xb[None, :, :] - z[:, None, :]) / w[:, None, :]    # (m, nb, d)
        h = torch.round(t)                       # half to even
        weight = bucket_value(bucket, h - t).prod(-1)
        hi = h.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).nan_to_num(0.0)
        hi = hi.to(torch.int64) & MASK32          # int32 bits, saturated
        key1 = _key(hi, r1[:, None, :])
        key2 = _key(hi, r2[:, None, :])
        sign = 1.0 - 2.0 * (key2 >> 31).to(torch.float32)
        idx[:, i:i + rows] = base + (key1 & (table_size - 1))
        coeff[:, i:i + rows] = weight * sign
    return idx, coeff


def loads(idx: torch.Tensor, coeff: torch.Tensor, v: torch.Tensor,
          table_size: int) -> torch.Tensor:
    """(m, B) tables: table_s[j] = sum over points i in slot j of
    coeff_s[i] v[i], in v's dtype."""
    m = idx.shape[0]
    tables = torch.zeros(m * table_size, dtype=v.dtype, device=v.device)
    tables.index_add_(0, idx.view(-1), (coeff.to(v.dtype) * v).view(-1))
    return tables.view(m, table_size)


def readout(idx: torch.Tensor, coeff: torch.Tensor,
            tables: torch.Tensor) -> torch.Tensor:
    """(1/m) sum_s coeff_s[i] tables_s[slot_s[i]] for every point i, summed
    in float32, returned in the tables' dtype."""
    vals = tables.view(-1)[idx] * coeff.to(tables.dtype)
    return vals.float().mean(0).to(tables.dtype)


def matvec(idx, coeff, v, table_size):
    """K~ v: the tables of v, read back at every point."""
    return readout(idx, coeff, loads(idx, coeff, v, table_size))


def _dot(a, b) -> float:
    return float((a.float() * b.float()).sum())


def pcg(mv, y: torch.Tensor, lam: float, *, tol: float, atol: float,
        maxiter: int):
    """CG on (K~ + lam I) beta = y from beta = 0, in y's dtype; returns
    (beta, iterations)."""
    beta = torch.zeros_like(y)
    r = y.clone()
    p = r.clone()
    rho = _dot(r, r)
    thresh = max(tol * math.sqrt(rho), atol) ** 2
    it = 0
    while it < maxiter and rho > thresh:
        ap = mv(p) + lam * p
        alpha = rho / max(_dot(p, ap), 1e-30)
        beta = beta + alpha * p
        r = r - alpha * ap
        it += 1
        rho_new = _dot(r, r)
        if not (math.isfinite(rho_new) and rho_new > thresh):
            break
        p = r + (rho_new / rho) * p
        rho = rho_new
    return beta, it


def fit(x, y, lsh, cfg: dict, *, dtype=torch.float32, feats=None):
    """The reference fit of ``cfg`` (bucket, table_size, lam, tol, atol,
    maxiter): (beta, tables, iterations).  ``feats`` reuses (idx, coeff)
    of x from ``features``."""
    idx, coeff = feats if feats is not None else features(
        x, lsh, cfg["bucket"], cfg["table_size"])
    coeff = coeff.to(dtype)
    table_size = cfg["table_size"]
    beta, it = pcg(lambda v: matvec(idx, coeff, v, table_size),
                   y.to(dtype), cfg["lam"], tol=cfg["tol"],
                   atol=cfg["atol"], maxiter=cfg["maxiter"])
    return beta, loads(idx, coeff, beta, table_size), it


def predict(xq, lsh, cfg: dict, tables: torch.Tensor) -> torch.Tensor:
    """Predictions at xq from ``tables`` (m, B), in the tables' dtype."""
    idx, coeff = features(xq, lsh, cfg["bucket"], cfg["table_size"])
    return readout(idx, coeff, tables)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: one wrong answer among millions
    moves it."""
    got = got.float().reshape(-1)
    want = want.float().reshape(-1)
    if got.shape != want.shape:
        return math.inf
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not math.isfinite(err):
        return math.inf
    return err / scale if scale > 0 else err
