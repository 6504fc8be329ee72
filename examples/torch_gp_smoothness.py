"""Paper §3.2 / Table 1 on the PyTorch port: smooth WLSH kernels for GP
regression.

Shows the paper's central qualitative claim: plain random binning (f = rect)
gives a NON-smooth kernel (Laplace) that underfits smooth processes, while the
weighted estimator with the smooth bucket f = (rect*rect_1/4*rect_1/4)(2x) and
p(w) = w^6 e^-w / 6! yields a Matern-like smooth kernel — same machinery,
strictly wider kernel family.  Each kernel's lengthscale is selected on a
validation split (the kernels' native scales differ by ~an order of
magnitude, so a fixed lengthscale would compare apples to oranges).

    PYTHONPATH=src python examples/torch_gp_smoothness.py [--device cuda|cpu]

Every fit runs the exact estimator (``mode="exact"``: the sorted-bucket
matvec in plain PyTorch on the device, its prediction tables from the
point-scatter kernel); the data and the LSH instances are drawn with numpy
from fixed seeds.
"""
import argparse

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import (GammaPDF, WLSHKernelSpec, gaussian_kernel,
                              get_bucket_fn, sample_lsh_params, wlsh_krr_fit,
                              wlsh_krr_predict)
from repro_torch.core.gp import gp_regression_dataset

N_TRAIN, N_VAL, N_TEST, D = 1200, 300, 500, 3
M, LAM = 800, 0.05
ELLS = (0.125, 0.25, 0.5, 1.0)
BUCKETS = (("rect (plain binning -> Laplace kernel)", "rect",
            GammaPDF(2.0, 1.0)),
           ("smooth (weighted -> Matern-like kernel)", "smooth",
            GammaPDF(7.0, 1.0)))


def _rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def make_data(device):
    """The SMOOTH ground truth (squared-exponential covariance, seed 1),
    split: (xtr, ytr, xval, yval, xte, fte)."""
    x, y, f_true = gp_regression_dataset(
        np.random.default_rng(1), gaussian_kernel,
        n=N_TRAIN + N_VAL + N_TEST, d=D, noise=0.05, device=device)
    a, b = N_TRAIN, N_TRAIN + N_VAL
    return x[:a], y[:a], x[a:b], y[a:b], x[b:], f_true[b:]


def fit_with_ell_selection(draw, xtr, ytr, xval, yval, bucket, pdf, *, m,
                           lam, ells=ELLS, device=None):
    """The exact-mode fit at each lengthscale, the instances ``draw(m, ell)``
    each time; returns (model, validation RMSE, ell) of the best."""
    best = (None, np.inf, None)
    for ell in ells:
        spec = WLSHKernelSpec(bucket=get_bucket_fn(bucket), pdf=pdf,
                              lengthscale=ell)
        model = wlsh_krr_fit(draw(m, ell), xtr, ytr, spec, lam=lam,
                             mode="exact", device=device)
        rmse = _rmse(wlsh_krr_predict(model, xval), yval)
        if rmse < best[1]:
            best = (model, rmse, ell)
    return best


def numpy_draws(label: str, pdf: GammaPDF, d: int, device):
    """The instances of one bucket's fits: the same numpy stream (seeded by
    the label's length, as the JAX example folds it into its key) scaled by
    each lengthscale."""
    return lambda m, ell: sample_lsh_params(
        np.random.default_rng((1, len(label))), m, d, pdf, ell,
        device=device)


def run(data, draws, *, m=M, lam=LAM, ells=ELLS, device=None) -> dict:
    """label -> (test RMSE, selected ell) for both buckets; ``draws[label]``
    gives each bucket's instances."""
    xtr, ytr, xval, yval, xte, fte = data
    results = {}
    for label, bucket, pdf in BUCKETS:
        model, _, ell = fit_with_ell_selection(
            draws[label], xtr, ytr, xval, yval, bucket, pdf, m=m, lam=lam,
            ells=ells, device=device)
        results[label] = (_rmse(wlsh_krr_predict(model, xte), fte), ell)
    return results


def report(results: dict) -> None:
    for label, (rmse, ell) in results.items():
        print(f"{label:45s} test RMSE = {rmse:.4f}  (ell*={ell})")
    smooth_rmse = results[BUCKETS[1][0]][0]
    rect_rmse = results[BUCKETS[0][0]][0]
    print(f"\nsmooth-bucket WLSH vs plain binning on a smooth target: "
          f"{(1 - smooth_rmse / rect_rmse) * 100:+.1f}% RMSE change")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    draws = {label: numpy_draws(label, pdf, D, dev)
             for label, _, pdf in BUCKETS}
    report(run(make_data(dev), draws, device=dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
