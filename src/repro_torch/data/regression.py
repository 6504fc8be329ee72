"""Synthetic regression data with the target recipe of the JAX package
(``repro.data.regression``), drawn with numpy from a seed: a smooth
random-feature part plus |w.x - b| kinks plus noise, standardized on the
training split.  Same recipe, not the same numbers as ``jax.random``."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RegressionSpec(NamedTuple):
    name: str
    dim: int
    n_train: int
    n_test: int
    rough: float        # weight of the non-smooth (|.|-kink) target component


# the paper's Table-2 datasets (sizes as in the paper: train + test)
REGRESSION_DATASETS: dict[str, RegressionSpec] = {
    "wine": RegressionSpec("wine", 11, 4000, 2497, rough=0.3),
    "insurance": RegressionSpec("insurance", 85, 5822, 4000, rough=0.2),
    "ct_slices": RegressionSpec("ct_slices", 384, 35000, 18500, rough=0.4),
    "forest": RegressionSpec("forest", 54, 500000, 81012, rough=0.5),
}


def _target(rng: np.random.Generator, x: np.ndarray, rough: float):
    d = x.shape[-1]
    w_s = (rng.standard_normal((d, 16)) / np.sqrt(d)).astype(np.float32)
    b_s = rng.uniform(0.0, 2 * np.pi, 16).astype(np.float32)
    smooth = np.cos(x @ w_s + b_s).sum(-1) / 4.0
    w_r = (rng.standard_normal((d, 8)) / np.sqrt(d)).astype(np.float32)
    b_r = (rng.standard_normal(8) * 0.3).astype(np.float32)
    kinks = np.abs(x @ w_r - b_r).sum(-1) / 8.0
    return (1.0 - rough) * smooth + rough * kinks


def make_regression(n_train: int, n_test: int, dim: int, *, rough: float,
                    seed: int = 0, noise: float = 0.1):
    """(x_train, y_train, x_test, y_test) as float32 numpy arrays; x is
    uniform on [0, 2]^dim."""
    rng = np.random.default_rng(seed)
    x = rng.random((n_train + n_test, dim), dtype=np.float32) * 2.0
    y = _target(rng, x, rough)
    y = y + noise * rng.standard_normal(y.shape, dtype=np.float32)
    mu, sd = y[:n_train].mean(), y[:n_train].std() + 1e-9
    y = ((y - mu) / sd).astype(np.float32)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def make_regression_dataset(name: str, seed: int = 0, *, scale: float = 1.0,
                            noise: float = 0.1):
    """A Table-2 stand-in; ``scale`` < 1 shrinks the sizes proportionally."""
    spec = REGRESSION_DATASETS[name]
    return make_regression(max(64, int(spec.n_train * scale)),
                           max(64, int(spec.n_test * scale)), spec.dim,
                           rough=spec.rough, seed=seed, noise=noise)
