"""Bucket-shaping functions f for the WLSH estimator (paper Def. 6/8).

Every f is even, supported on [-1/2, 1/2], and normalized so that ||f||_2 = 1.
``eval_fn`` evaluates f on a float32 tensor with the arithmetic of the JAX
package (so weights agree to rounding); the autocorrelation tables stay numpy.
``kernel_id`` and ``kernel_const`` tell the CUDA featurize kernel which
closed form to evaluate (csrc/featurize.cu, ``bucket_value``).

  * ``rect``   — paper's Section-5 choice; recovers Rahimi–Recht random binning.
  * ``tent``   — C^0: (rect * rect)(2x), one bounded derivative.
  * ``smooth`` — paper's Table-1 choice (rect * rect_{1/4} * rect_{1/4})(2x).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

_ACORR_GRID = 8192


@dataclasses.dataclass(frozen=True, eq=False)
class BucketFn:
    """A bucket-shaping function with the metadata the theory needs."""

    name: str
    eval_fn: Callable[[torch.Tensor], torch.Tensor]
    f_inf: float
    smoothness: int
    kernel_id: int          # closed form selected in csrc/featurize.cu
    kernel_const: float     # its scale constant (sqrt 3, or the smooth norm)
    acorr_x: np.ndarray = dataclasses.field(repr=False, default=None)
    acorr_y: np.ndarray = dataclasses.field(repr=False, default=None)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.eval_fn(x)

    def acorr(self, t: np.ndarray) -> np.ndarray:
        """(f*f)(t) via the precomputed table (numpy; analysis/tests only)."""
        return np.interp(np.abs(np.asarray(t)), self.acorr_x, self.acorr_y,
                         left=0.0, right=0.0)


def _tabulate_acorr(eval_np):
    n = _ACORR_GRID
    xs = np.linspace(-0.5, 0.5, n + 1)
    dx = xs[1] - xs[0]
    fx = eval_np(xs)
    ac = np.convolve(fx, fx[::-1]) * dx
    ts = (np.arange(2 * n + 1) - n) * dx
    keep = ts >= 0.0
    return ts[keep], ac[keep]


# rect: f(x) = 1 on [-1/2, 1/2]

def _rect_eval(x: torch.Tensor) -> torch.Tensor:
    return (x.abs() <= 0.5).to(torch.float32)


def _rect_np(x):
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


# tent: f(x) = sqrt(3) * (1 - 2|x|) on [-1/2, 1/2]

_SQRT3 = float(np.sqrt(3.0))


def _tent_eval(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax <= 0.5, _SQRT3 * (1.0 - 2.0 * ax), 0.0)


def _tent_np(x):
    ax = np.abs(x)
    return np.where(ax <= 0.5, _SQRT3 * (1.0 - 2.0 * ax), 0.0)


# smooth: f(x) = c * G(2x), G = rect * rect_{1/4} * rect_{1/4}; with t = |2x|
#   G = 1/16 (t <= 1/4); -t^2/2 + t/4 + 1/32 (t <= 1/2); (3/4 - t)^2/2
#   (t <= 3/4); 0 otherwise.

def _smooth_G_np(t):
    t = np.abs(t)
    out = np.zeros_like(t, dtype=np.float64)
    m1 = t <= 0.25
    m2 = (t > 0.25) & (t <= 0.5)
    m3 = (t > 0.5) & (t <= 0.75)
    out[m1] = 1.0 / 16.0
    out[m2] = -0.5 * t[m2] ** 2 + 0.25 * t[m2] + 1.0 / 32.0
    out[m3] = 0.5 * (0.75 - t[m3]) ** 2
    return out


def _smooth_norm_const() -> float:
    ts = np.linspace(0.0, 0.75, 200001)
    val = np.trapezoid(_smooth_G_np(ts) ** 2, ts)
    return float(1.0 / np.sqrt(val))


_SMOOTH_C = _smooth_norm_const()


def _smooth_eval(x: torch.Tensor) -> torch.Tensor:
    t = (2.0 * x).abs()
    p1 = torch.full_like(t, 1.0 / 16.0)
    p2 = -0.5 * t * t + 0.25 * t + 1.0 / 32.0
    p3 = 0.5 * (0.75 - t) ** 2
    out = torch.where(t <= 0.25, p1, torch.where(
        t <= 0.5, p2, torch.where(t <= 0.75, p3, 0.0)))
    return _SMOOTH_C * out


def _smooth_np(x):
    return _SMOOTH_C * _smooth_G_np(2.0 * np.asarray(x, dtype=np.float64))


def _make(name, eval_fn, eval_np, f_inf, smoothness, kernel_id, const):
    ax, ay = _tabulate_acorr(eval_np)
    return BucketFn(name=name, eval_fn=eval_fn, f_inf=f_inf,
                    smoothness=smoothness, kernel_id=kernel_id,
                    kernel_const=const, acorr_x=ax, acorr_y=ay)


RECT = _make("rect", _rect_eval, _rect_np, 1.0, 0, 0, 1.0)
TENT = _make("tent", _tent_eval, _tent_np, _SQRT3, 1, 1, _SQRT3)
SMOOTH = _make("smooth", _smooth_eval, _smooth_np, _SMOOTH_C / 16.0, 2, 2,
               _SMOOTH_C)

BUCKET_FNS = {"rect": RECT, "tent": TENT, "smooth": SMOOTH}


def get_bucket_fn(name: str) -> BucketFn:
    try:
        return BUCKET_FNS[name]
    except KeyError:
        raise ValueError(f"unknown bucket fn {name!r}; "
                         f"have {sorted(BUCKET_FNS)}") from None
