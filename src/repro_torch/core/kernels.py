"""Kernel specification of the WLSH estimator and the Laplace kernel of the
exact baseline.  With f = rect and p = Gamma(2, 1) the WLSH kernel is the
Laplace kernel e^{-|x|_1}."""
from __future__ import annotations

import dataclasses

import torch

from .bucket_fns import BucketFn
from .lsh import GammaPDF


@dataclasses.dataclass(frozen=True)
class WLSHKernelSpec:
    """The (f, p) pair that defines a WLSH kernel k_{f,p} and its estimator."""

    bucket: BucketFn
    pdf: GammaPDF = GammaPDF(2.0, 1.0)
    lengthscale: float = 1.0


def laplace_kernel(x: torch.Tensor, y: torch.Tensor,
                   lengthscale: float = 1.0) -> torch.Tensor:
    """k(x, y) = exp(-||x - y||_1 / ell)."""
    diff = x[:, None, :] - y[None, :, :]
    return torch.exp(-diff.abs().sum(-1) / lengthscale)
