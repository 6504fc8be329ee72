"""The inputs of a run, made from ``--seed`` alone: the one general
generator that every configuration and traffic mix is read through.

The same seed gives the same inputs.  Bulk data (points, targets, queries)
is drawn on the run's device with a ``torch.Generator`` in a few large
calls; the m x d LSH parameters on the host with numpy.  Every draw has its
own stream, so a mix that draws more of one kind leaves the others as
they were.

A configuration's points and targets come from its data recipe,
``recipes/<data.recipe>.py``.  Frozen copies, so that the program can
change without moving the yardstick:
* the median-distance rule of ``chip_smoke.py``'s Table 2 rows (the
  lengthscale is half the median L1 distance between 256 sampled points,
  all their pairs, the diagonal included),
* the LSH draw of ``core.lsh.sample_lsh_params`` (w ~ Gamma(shape, scale)
  times the lengthscale, z ~ U[0, w), odd 32-bit multipliers).
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import found

BENCH_DIR = Path(__file__).resolve().parent

STREAMS = {"lsh": 1, "points": 2, "targets": 3, "queries": 4,
           "lengthscale": 5, "sample": 6}
MEDIAN_SAMPLE = 256


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    return (int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63)


def generator(device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def host_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


class Inputs(NamedTuple):
    x: torch.Tensor                 # (n, d) training points
    targets: torch.Tensor           # (T, n) target vectors
    lsh: dict                       # numpy w, z (float32), r1, r2 (uint32)
    lengthscale: float
    queries: torch.Tensor | None    # (blocks, rows, d) or None


def lengthscale(cfg: dict, x: torch.Tensor, seed: int) -> float:
    rule = cfg["lengthscale"]
    if isinstance(rule, (int, float)):
        return float(rule)
    if rule != "half_median_l1":
        raise ValueError(f"unknown lengthscale rule {rule!r}")
    g = torch.Generator()
    g.manual_seed(sub_seed(seed, "lengthscale"))
    k = min(MEDIAN_SAMPLE, x.shape[0])
    rows = torch.randperm(x.shape[0], generator=g)[:k].to(x.device)
    xs = x[rows].double()
    dist = (xs[:, None, :] - xs[None, :, :]).abs().sum(-1)
    return float(torch.quantile(dist.reshape(-1), 0.5)) / 2.0


def lsh_params(cfg: dict, seed: int, ell: float) -> dict:
    rng = host_rng(seed, "lsh")
    m, d = cfg["m"], cfg["dim"]
    shape, scale = cfg["pdf"]["shape"], cfg["pdf"]["scale"]
    w = (rng.gamma(shape, 1.0, (m, d)).astype(np.float32)
         * np.float32(scale) * np.float32(ell))
    z = rng.random((m, d), dtype=np.float32) * w
    imax = np.iinfo(np.int32).max
    r1 = (rng.integers(0, imax, (m, d)).astype(np.uint32) << 1) | 1
    r2 = (rng.integers(0, imax, (m, d)).astype(np.uint32) << 1) | 1
    return {"w": w, "z": z, "r1": r1, "r2": r2}


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                bench_dir=BENCH_DIR) -> Inputs:
    recipe = found.load(bench_dir, "recipes", cfg["data"]["recipe"])
    x = recipe.points(cfg, cfg["n_points"],
                      generator(device, seed, "points"), device)
    ys = recipe.targets(cfg, x, traffic["targets"],
                        generator(device, seed, "targets"))
    ell = lengthscale(cfg, x, seed)
    queries = None
    if traffic.get("blocks"):
        g = generator(device, seed, "queries")
        rows = traffic["blocks"] * traffic["block_rows"]
        queries = recipe.points(cfg, rows, g, device).view(
            traffic["blocks"], traffic["block_rows"], cfg["dim"])
    return Inputs(x=x, targets=ys, lsh=lsh_params(cfg, seed, ell),
                  lengthscale=ell, queries=queries)


def reference_lsh(lsh: dict, device) -> dict:
    """The LSH parameters as the reference reads them: float32 w, z and
    int64 r1, r2 on ``device``."""
    return {"w": torch.from_numpy(lsh["w"]).to(device),
            "z": torch.from_numpy(lsh["z"]).to(device),
            "r1": torch.from_numpy(lsh["r1"].astype(np.int64)).to(device),
            "r2": torch.from_numpy(lsh["r2"].astype(np.int64)).to(device)}
