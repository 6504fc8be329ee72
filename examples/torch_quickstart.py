"""Quickstart of the PyTorch port: approximate kernel ridge regression with
WLSH estimators, on one NVIDIA card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
        [--precond none|jacobi|nystrom] [--num-rhs K]

Fits a Laplace-kernel GP sample with (a) exact KRR, (b) WLSH approximate KRR
(the paper's method), and compares accuracy and fit time.  ``--device``
picks where it runs: 'cuda' (the default) runs the hand-written kernels on
the card and raises without one; 'cpu' runs their plain PyTorch versions.
``--precond`` runs the solve as preconditioned CG
(``repro_torch.core.precond``; 'nystrom' collapses the iteration count on
ill-conditioned, small-lam problems).  ``--num-rhs K`` with K > 1 draws
K - 1 GP posterior samples alongside the mean via pathwise conditioning —
one batched multi-RHS solve instead of K separate fits
(``repro_torch.core.gp``).  Prediction streams through fixed-size batches —
the same code path that serves multi-million-point inference.

``--export DIR`` writes the fitted model as a serving artifact
(``repro_torch.serve.artifact``, the JAX package's format) and ``--serve
DIR`` loads it back through the online Predictor and round-trips a request
sample — the export -> serve hop that ``python -m
repro_torch.launch.krr_serve --artifact DIR`` then runs at traffic.  The
data and the LSH instances are drawn with numpy from fixed seeds.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import (WLSHKernelSpec, exact_krr_fit,
                              exact_krr_predict, get_bucket_fn,
                              laplace_kernel, sample_lsh_params, wlsh_krr_fit,
                              wlsh_krr_predict)
from repro_torch.core.gp import gp_posterior_rhs, gp_regression_dataset
from repro_torch.core.precond import DEFAULT_NYSTROM_RANK

N_TRAIN, N_TEST, D, M, LAM, NOISE = 1200, 400, 4, 400, 0.3, 0.05
# WLSH: f = rect + p(w) = w e^{-w}  <=>  the Laplace kernel (Def. 8)
SPEC = WLSHKernelSpec(bucket=get_bucket_fn("rect"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's kernels (raises without a card); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--fused", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="one-pass slot-blocked CG matvec (--no-fused keeps "
                         "the split scatter->gather path reachable for A/B)")
    ap.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "nystrom"],
                    help="PCG preconditioner for the WLSH solve")
    ap.add_argument("--precond-rank", type=int, default=DEFAULT_NYSTROM_RANK)
    ap.add_argument("--num-rhs", type=int, default=1,
                    help="K > 1 adds K-1 pathwise GP posterior samples to "
                         "the solve as extra RHS columns (one batched fit)")
    ap.add_argument("--solve-checkpoint-dir", default=None, metavar="DIR",
                    help="persist the PCG SolveState under DIR during the "
                         "fit; re-running after a preemption resumes the "
                         "solve from the last saved chunk")
    ap.add_argument("--solve-checkpoint-every", type=int, default=0,
                    help="iterations between SolveState saves (0 with a "
                         "dir set = maxiter//10)")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="write the fitted WLSH model as a serving artifact")
    ap.add_argument("--serve", default=None, metavar="DIR",
                    help="load the artifact back through the online "
                         "Predictor and verify the round-trip (defaults to "
                         "the --export dir when both are wanted)")
    return ap.parse_args(argv)


def _clock(dev: torch.device) -> float:
    """The host clock after the card's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a - b) ** 2)))


def make_data(device):
    """The GP sample (seed 0) split into train and test: (x, xtr, ytr, xte,
    fte), ``x`` all points."""
    x, y, f_true = gp_regression_dataset(
        np.random.default_rng(0), laplace_kernel, n=N_TRAIN + N_TEST, d=D,
        noise=NOISE, device=device)
    return (x, x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], f_true[N_TRAIN:])


def fit_wlsh(lsh, xtr, target, args, device):
    """WLSH-KRR of ``SPEC`` with the instances ``lsh``."""
    return wlsh_krr_fit(lsh, xtr, target, SPEC, lam=LAM, fused=args.fused,
                        precond=args.precond, precond_rank=args.precond_rank,
                        solve_checkpoint_dir=args.solve_checkpoint_dir,
                        solve_checkpoint_every=args.solve_checkpoint_every,
                        device=device)


def serve_round_trip(args, model, xte, dev) -> None:
    """Export the fitted model, load it back through the online predictor,
    and check artifact == in-memory predictions."""
    from repro_torch.serve import Predictor, export_artifact
    if args.export:
        aid = export_artifact(args.export, model)
        print(f"serving    : exported artifact {aid!r} -> {args.export}")
    serve_dir = args.serve or args.export
    predictor = Predictor(device=dev, cache_entries=4096)
    aid = predictor.load(serve_dir)
    predictor.warmup(sizes=(1, 256))
    # a power-of-two query count keeps the predictor's padded shape equal
    # to the direct path's shape
    xq = xte[:256].cpu().numpy().astype(np.float32)
    served = predictor.predict(xq)
    bitwise = False
    compared = bool(args.export) and serve_dir == args.export
    if compared:
        # the artifact IS this run's fit: the card's served rows are
        # bitwise the direct predict's; the CPU's plain readout regroups
        # the mean over the instances with the padding -> <=1e-6
        direct = wlsh_krr_predict(model, xte[:256]).cpu().numpy()
        bitwise = np.array_equal(served, direct)
        assert bitwise or np.allclose(served, direct, atol=1e-6), \
            "served predictions diverged from the in-memory model"
    again = predictor.predict(xq)
    assert np.array_equal(again, served), "cache replay not bitwise"
    t0 = time.perf_counter()
    for row in xte[:64].cpu().numpy().astype(np.float32):
        predictor.predict(row)
    per_query = (time.perf_counter() - t0) / 64
    verdict = ("round-trip bitwise" if bitwise else
               "round-trip <=1e-6" if compared else
               "served (no in-memory model to compare)")
    print(f"serving    : {verdict} over {len(served)} "
          f"test points; single-query warm+cache path "
          f"{per_query * 1e6:.0f}us/query "
          f"(cache hit rate "
          f"{predictor.cache_stats(artifact_id=aid)['hit_rate']:.2f})")


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    x, xtr, ytr, xte, fte = make_data(dev)

    t0 = _clock(dev)
    beta = exact_krr_fit(laplace_kernel, xtr, ytr, LAM)
    pred_exact = exact_krr_predict(laplace_kernel, xtr, beta, xte)
    t_exact = _clock(dev) - t0
    rmse_exact = _rmse(pred_exact, fte)

    n_samples = max(args.num_rhs - 1, 0)
    target = ytr
    f_prior = None
    if n_samples:
        # pathwise conditioning: the sample RHS columns solve against the
        # SAME operator as the mean, so the whole batch is one block solve;
        # eps ~ N(0, lam): KRR with lam IS GP regression with assumed noise
        # variance lam
        target, f_prior = gp_posterior_rhs(
            np.random.default_rng(2), x, ytr, laplace_kernel,
            n_train=N_TRAIN, n_samples=n_samples, noise=float(LAM) ** 0.5)
    lsh = sample_lsh_params(np.random.default_rng(1), M, D, SPEC.pdf,
                            SPEC.lengthscale, device=dev)
    t0 = _clock(dev)
    model = fit_wlsh(lsh, xtr, target, args, dev)
    # batch_size streams the test set in fixed memory (O(batch * m) peak)
    pred_wlsh = wlsh_krr_predict(model, xte, batch_size=128)
    t_wlsh = _clock(dev) - t0
    if n_samples:
        posterior_samples = f_prior[N_TRAIN:] + pred_wlsh[:, 1:]
        pred_wlsh = pred_wlsh[:, 0]
        spread = float(torch.mean(torch.std(posterior_samples, dim=1,
                                            correction=0)))
    rmse_wlsh = _rmse(pred_wlsh, fte)

    cg_iters = int(model.cg_col_iters.max())
    print(f"exact KRR : rmse={rmse_exact:.4f}  fit+predict={t_exact:.2f}s "
          f"(O(n^3) solve)")
    print(f"WLSH KRR  : rmse={rmse_wlsh:.4f}  fit+predict={t_wlsh:.2f}s "
          f"(device={dev.type}, m={M} instances, O(n m) per CG "
          f"iteration, {cg_iters} iters, precond={model.precond})")
    if n_samples:
        print(f"GP posterior: {n_samples} pathwise samples in the same "
              f"solve; mean test-point std {spread:.4f}")
    assert rmse_wlsh < 2.0 * rmse_exact + 0.05, "WLSH should track exact KRR"

    if args.serve is not None or args.export:
        serve_round_trip(args, model, xte, dev)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
