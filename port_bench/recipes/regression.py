"""The regression recipe, a frozen copy of the JAX package's
``data/regression.py``: points uniform on [low, high]^d; a target of 16
random cosine features and 8 |w.x - b| kinks weighted by ``rough``, plus
Gaussian noise, standardized."""
from __future__ import annotations

import math

import torch


def points(cfg: dict, rows: int, g: torch.Generator, device):
    lo, hi = cfg["data"]["low"], cfg["data"]["high"]
    return torch.rand((rows, cfg["dim"]), generator=g,
                      device=device) * (hi - lo) + lo


def targets(cfg: dict, x: torch.Tensor, count: int,
            g: torch.Generator) -> torch.Tensor:
    """``count`` standardized targets at x."""
    rough, noise = cfg["data"]["rough"], cfg["data"]["noise"]
    n, d = x.shape
    dev = x.device
    out = torch.empty((count, n), dtype=torch.float32, device=dev)
    for j in range(count):
        w_s = torch.randn((d, 16), generator=g, device=dev) / math.sqrt(d)
        b_s = torch.rand(16, generator=g, device=dev) * (2 * math.pi)
        smooth = torch.cos(x @ w_s + b_s).sum(-1) / 4.0
        w_r = torch.randn((d, 8), generator=g, device=dev) / math.sqrt(d)
        b_r = torch.randn(8, generator=g, device=dev) * 0.3
        kinks = (x @ w_r - b_r).abs().sum(-1) / 8.0
        y = (1.0 - rough) * smooth + rough * kinks
        y = y + noise * torch.randn(n, generator=g, device=dev)
        out[j] = (y - y.mean()) / (y.std(unbiased=False) + 1e-9)
    return out
