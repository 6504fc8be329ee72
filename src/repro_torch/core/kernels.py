"""Analytic kernel functions, as in the JAX package's ``core/kernels.py``.

The classical shift-invariant kernels of the paper's experiments (Laplace,
squared exponential, Matérn-5/2) and the analytic WLSH kernel of Def. 8:

    k_{f,p}(x) = prod_l  E_{w ~ p} [ (f*f)(x_l / w) ]

tabulated once by numpy quadrature over w against the tabulated
autocorrelation f*f (bit for bit the JAX package's table) and evaluated by
linear interpolation.  With f = rect and p = Gamma(2, 1) it is the Laplace
kernel e^{-|x|_1}.

Pairwise kernels evaluate the JAX package's per-element formula (the
difference of every coordinate, then the sum over coordinates) in blocks of
rows, so no (n, n', d) difference tensor exists at once.  The L2 kernels do
not use ``torch.cdist``'s matmul expansion, which loses the small distances
the Gaussian kernel is most sensitive to.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .bucket_fns import BucketFn
from .lsh import GammaPDF

# elements of one block's (rows, n', d) difference tensor: 512 MiB in f32,
# about 1 GiB with the block's one elementwise intermediate
PAIRWISE_BLOCK_ELEMS = 1 << 27


def _row_blocks(x: torch.Tensor, y: torch.Tensor, fn) -> torch.Tensor:
    """cat over row blocks of x of fn(x[i:j, None, :] - y[None, :, :]),
    each fn reducing the last axis: an (n, n') result."""
    n = x.shape[0]
    rows = max(1, PAIRWISE_BLOCK_ELEMS // max(1, y.shape[0] * x.shape[1]))
    if n <= rows:
        return fn(x[:, None, :] - y[None, :, :])
    return torch.cat([fn(x[i:i + rows, None, :] - y[None, :, :])
                      for i in range(0, n, rows)])


def _pairwise_dists(x: torch.Tensor, y: torch.Tensor,
                    ord_: int) -> torch.Tensor:
    if ord_ == 1:
        return _row_blocks(x, y, lambda diff: diff.abs().sum(-1))
    return _row_blocks(x, y, lambda diff: torch.sqrt(
        (diff * diff).sum(-1).clamp(min=0.0)))


def laplace_kernel(x: torch.Tensor, y: torch.Tensor,
                   lengthscale: float = 1.0) -> torch.Tensor:
    """k(x, y) = exp(-||x - y||_1 / ell)."""
    return torch.exp(-_pairwise_dists(x, y, 1) / lengthscale)


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor,
                    lengthscale: float = 1.0) -> torch.Tensor:
    """Squared exponential, the paper's convention:
    exp(-||x-y||_2^2 / ell^2)."""
    d = _pairwise_dists(x, y, 2)
    return torch.exp(-(d / lengthscale) ** 2)


def matern52_kernel(x: torch.Tensor, y: torch.Tensor,
                    lengthscale: float = 1.0) -> torch.Tensor:
    """C_{5/2}(r) = (1 + r + r^2/3) exp(-r), r = ||x-y||_2 / ell."""
    r = _pairwise_dists(x, y, 2) / lengthscale
    return (1.0 + r + r * r / 3.0) * torch.exp(-r)


# ---------------------------------------------------------------------------
# analytic WLSH kernel (Def. 8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WLSHKernelSpec:
    """The (f, p) pair that defines a WLSH kernel k_{f,p} and its estimator."""

    bucket: BucketFn
    pdf: GammaPDF = GammaPDF(2.0, 1.0)
    lengthscale: float = 1.0


def _gamma_pdf_np(w: np.ndarray, pdf: GammaPDF) -> np.ndarray:
    from math import gamma as _g
    sh, sc = pdf.shape, pdf.scale
    w = np.maximum(w, 1e-300)
    return w ** (sh - 1.0) * np.exp(-w / sc) / (_g(sh) * sc ** sh)


def tabulate_wlsh_k1d(spec: WLSHKernelSpec, x_max: float = 40.0,
                      n_x: int = 4096,
                      n_w: int = 20000) -> tuple[np.ndarray, np.ndarray]:
    """k1d(x) = int_0^inf p(w) (f*f)(x/w) dw on a grid of |x| values (numpy,
    the JAX package's quadrature step for step, so the arrays are equal).

    (f*f) has support [-1, 1], so the integrand vanishes for w < |x|: it is
    masked there on one shared grid of w."""
    xs = np.linspace(0.0, x_max, n_x)
    # shared w grid over (0, W]; Gamma(shape <= 9) mass above 60 is ~1e-20
    w_hi = spec.pdf.scale * (spec.pdf.shape + 40.0 * np.sqrt(spec.pdf.shape)
                             + 40.0)
    w = np.concatenate([np.linspace(1e-6, 1.0, n_w // 2, endpoint=False),
                        np.geomspace(1.0, w_hi, n_w // 2)])
    pw = _gamma_pdf_np(w, spec.pdf)
    ratio = xs[:, None] / np.maximum(w[None, :], 1e-30)
    vals = spec.bucket.acorr(ratio) * pw[None, :]
    vals[ratio > 1.0] = 0.0
    k = np.trapezoid(vals, w, axis=1)
    # ||f||_2 = 1 gives k(0) = 1 in theory; pin the ~1e-5 quadrature error
    return xs, k / max(k[0], 1e-30)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, *,
           left: float, right: float) -> torch.Tensor:
    """``jnp.interp(x, xp, fp, left=left, right=right)`` for increasing
    1-D ``xp``: the same bracket (searchsorted, right side, clipped) and
    the same arithmetic."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0,
                    f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (fp[i] - f0))
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


@dataclasses.dataclass(frozen=True)
class WLSHKernel:
    """Evaluatable analytic WLSH kernel (product over dimensions)."""

    spec: WLSHKernelSpec
    table_x: np.ndarray
    table_y: np.ndarray

    def k1d(self, t: torch.Tensor) -> torch.Tensor:
        # the tables in float32, as jnp.asarray makes them without x64
        tx, ty = (torch.from_numpy(a.astype(np.float32)).to(t.device)
                  for a in (self.table_x, self.table_y))
        return interp(t.abs() / self.spec.lengthscale, tx, ty, left=1.0,
                      right=0.0)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _row_blocks(x, y, lambda diff: torch.prod(self.k1d(diff),
                                                         dim=-1))


def make_wlsh_kernel(spec: WLSHKernelSpec) -> WLSHKernel:
    xs, ys = tabulate_wlsh_k1d(spec)
    return WLSHKernel(spec=spec, table_x=xs, table_y=ys)


KERNELS: dict[str, Callable[..., torch.Tensor]] = {
    "laplace": laplace_kernel,
    "gaussian": gaussian_kernel,
    "matern52": matern52_kernel,
}
