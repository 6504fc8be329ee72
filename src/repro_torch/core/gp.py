"""Gaussian-process sampling for the paper's Table 1, and the right-hand
sides of batched posterior sampling (the JAX package's ``core/gp.py``).

Posterior samples use pathwise conditioning (Matheron's rule):

    f_post = f_prior + K(., X) (K + s^2 I)^-1 (y - f_prior(X) - eps)

so S samples and the posterior mean are S + 1 solves against the same
operator: one multi-RHS ``wlsh_krr_fit``.

Draws come from an explicit ``numpy.random.Generator`` on the host, as
``sample_lsh_params`` takes one; the kernel matrix, its ``eigh`` (float32
unless the kernel gives float64, as in JAX without x64) and the products
run on the device of the points.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import resolve_device


def _normal(rng: np.random.Generator, shape, like: torch.Tensor):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=like.device, dtype=like.dtype)


def kernel_root(x: torch.Tensor, kernel_fn,
                jitter: float = 1e-6) -> torch.Tensor:
    """R with R R^T = K(x, x) up to the clamp: eigenvectors scaled by the
    square roots of the eigenvalues, clamped at ``jitter``.  An
    eigendecomposition rather than Cholesky: smooth kernels are
    numerically rank-deficient on dense point sets."""
    k = kernel_fn(x, x)
    if k.dtype != torch.float64:
        k = k.to(torch.float32)
    evals, evecs = torch.linalg.eigh(k)
    return evecs * torch.sqrt(evals.clamp(min=jitter))[None, :]


def sample_gp(rng: np.random.Generator, x: torch.Tensor, kernel_fn,
              jitter: float = 1e-6) -> torch.Tensor:
    """One sample path of GP(0, k) at the rows of x, float32."""
    root = kernel_root(x, kernel_fn, jitter)
    return (root @ _normal(rng, (x.shape[0],), root)).to(torch.float32)


def gp_regression_dataset(rng: np.random.Generator, kernel_fn, *, n: int,
                          d: int, noise: float = 0.05, device=None):
    """Points uniform on [0, 1]^d, labels = GP sample + N(0, noise^2), on
    ``device`` (None: the card, raising without one): (x, y, f)."""
    dev = resolve_device(device)
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dev)
    f = sample_gp(rng, x, kernel_fn)
    y = f + noise * _normal(rng, (n,), f)
    return x, y, f


def sample_gp_batch(rng: np.random.Generator, x: torch.Tensor, kernel_fn,
                    n_samples: int, jitter: float = 1e-6) -> torch.Tensor:
    """(n, n_samples) independent GP(0, k) sample paths at the rows of x,
    one eigendecomposition shared by all draws."""
    root = kernel_root(x, kernel_fn, jitter)
    eps = _normal(rng, (x.shape[0], n_samples), root)
    return (root @ eps).to(torch.float32)


def gp_posterior_rhs(rng: np.random.Generator, x_all: torch.Tensor,
                     y: torch.Tensor, kernel_fn, *, n_train: int,
                     n_samples: int,
                     noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The (n_train, 1 + n_samples) RHS block of pathwise posterior
    sampling, and the (n_all, n_samples) joint prior draws f_j.  Column 0
    is y (its solve gives the posterior mean); column j is
    y - f_j(X) - eps_j with eps_j ~ N(0, noise^2)."""
    f_all = sample_gp_batch(rng, x_all, kernel_fn, n_samples)
    eps = noise * _normal(rng, (n_train, n_samples), f_all)
    rhs = torch.cat([y[:, None], y[:, None] - f_all[:n_train] - eps], dim=1)
    return rhs, f_all
