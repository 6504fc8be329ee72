"""Random Fourier Features baseline (Rahimi & Recht 2007), as compared
against in the paper's Table 2 (the JAX package's ``core/rff.py``).

Approximates the squared-exponential kernel exp(-||x-y||^2 / ell^2) with
phi(x) = sqrt(2/D) cos(x W + b), W ~ N(0, 2/ell^2 I), b ~ Unif[0, 2 pi].
KRR is solved in the primal: (Phi^T Phi + lam I_D) alpha = Phi^T y, O(n D^2).
The draw is separate from the solve (``rff_draw``, ``rff_krr_solve``), so
the solve can be given any W and b.  Plain PyTorch on the device of x.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..backend import as_tensor, resolve_device


class RFFModel(NamedTuple):
    w: torch.Tensor      # (d, D)
    b: torch.Tensor      # (D,)
    alpha: torch.Tensor  # (D,)


def rff_features(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    return math.sqrt(2.0 / w.shape[1]) * torch.cos(x @ w + b)


def rff_draw(rng: np.random.Generator, d: int, n_features: int,
             lengthscale: float = 1.0, *,
             device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, b) on ``device`` (None: the card, raising without one), drawn
    on the host from ``rng``: the spectral density of
    exp(-||delta||^2 / ell^2) is N(0, 2 / ell^2)."""
    device = resolve_device(device)
    w = (rng.standard_normal((d, n_features), dtype=np.float32)
         * np.float32(np.sqrt(2.0) / lengthscale))
    b = rng.uniform(0.0, 2.0 * np.pi, n_features).astype(np.float32)
    return (torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))


def rff_krr_solve(w: torch.Tensor, b: torch.Tensor, x, y, *,
                  lam: float) -> RFFModel:
    """The primal ridge solve on the features of the given W (d, D) and
    b (D,), on their device."""
    x, y = as_tensor(x, w.device), as_tensor(y, w.device)
    phi = rff_features(w, b, x)
    gram = phi.T @ phi + lam * torch.eye(w.shape[1], dtype=phi.dtype,
                                         device=phi.device)
    alpha = torch.linalg.solve(gram, phi.T @ y)
    return RFFModel(w=w, b=b, alpha=alpha)


def rff_krr_fit(rng: np.random.Generator, x, y, *, n_features: int,
                lam: float, lengthscale: float = 1.0,
                device=None) -> RFFModel:
    """Draw W and b from ``rng`` and solve, on ``device`` (None: the card,
    raising without one)."""
    dev = resolve_device(device)
    w, b = rff_draw(rng, np.shape(x)[1], n_features, lengthscale,
                    device=dev)
    return rff_krr_solve(w, b, x, y, lam=lam)


def rff_krr_predict(model: RFFModel, x_test) -> torch.Tensor:
    x_test = as_tensor(x_test, model.w.device)
    return rff_features(model.w, model.b, x_test) @ model.alpha
