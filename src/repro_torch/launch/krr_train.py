"""Distributed WLSH-KRR driver of the port — the paper's own workload on a
``torch.distributed`` group of ranks.

    # one rank on the card
    PYTHONPATH=src python -m repro_torch.launch.krr_train --dataset forest \\
        --scale 0.01 --m 64 --lam 0.5
    # two ranks on the CPU (gloo)
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.krr_train \\
        --device cpu --dataset wine --scale 0.05 --m 8 --cg-iters 5

The flags are those of ``repro.launch.krr_train`` with ``--device`` in place
of ``--backend``.  Ranks come from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``); without it the group has one rank.  NCCL on
the card, gloo on the CPU.  Every rank makes the same data from the seed and
keeps its own shard; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core.bucket_fns import get_bucket_fn
from ..core.distributed import (KRRStepConfig, OVERFLOW_POLICIES,
                                make_krr_predict, make_krr_predict_hashjoin,
                                make_krr_step, run_krr_step_resilient)
from ..core.lsh import GammaPDF, sample_lsh_params
from ..core.precond import DEFAULT_NYSTROM_RANK
from ..data import make_regression_dataset
from .mesh import init_distributed, local_lsh, local_tensor, make_host_mesh

# hash-join all_to_all payload dtypes
WIRE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pad_to(a: np.ndarray, mult: int) -> np.ndarray:
    pad = (-a.shape[0]) % mult
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) if pad else a


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="wine",
                    choices=["wine", "insurance", "ct_slices", "forest"])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="dataset size fraction")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--bucket", default="rect",
                    choices=["rect", "tent", "smooth"])
    ap.add_argument("--lengthscale", type=float, default=4.0)
    ap.add_argument("--cg-iters", type=int, default=50)
    ap.add_argument("--table-size", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels on the card (NCCL); cpu: "
                         "their plain versions (gloo)")
    ap.add_argument("--fused", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="one-pass matvec for the CG solve when there is one "
                         "data rank (--no-fused forces the split "
                         "scatter->gather path for A/B runs)")
    ap.add_argument("--blocked-split", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="split loads/readout off the slot-blocked layout "
                         "(--no-blocked-split: the point scatter and gather)")
    ap.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "nystrom"],
                    help="PCG preconditioner: jacobi works on any grid; "
                         "nystrom needs one data rank")
    ap.add_argument("--precond-rank", type=int, default=DEFAULT_NYSTROM_RANK,
                    help="Nystrom pivot rank (ignored by none/jacobi)")
    ap.add_argument("--table-mode", default="psum",
                    choices=["psum", "hashjoin"],
                    help="psum: dense (m, B) tables merged by all_reduce; "
                         "hashjoin: the table split over the data ranks, "
                         "only the nonzeros routed by all_to_all")
    ap.add_argument("--cap-factor", type=float, default=2.0,
                    help="hashjoin per-destination routing capacity factor "
                         "(overflow buckets are dropped and counted)")
    ap.add_argument("--overflow", default="warn",
                    choices=list(OVERFLOW_POLICIES),
                    help="hashjoin capacity-overflow policy")
    ap.add_argument("--wire-dtype", default="bf16",
                    choices=sorted(WIRE_DTYPES),
                    help="hashjoin all_to_all payload dtype")
    ap.add_argument("--num-rhs", type=int, default=1,
                    help="solve an (n, k) block: column 0 is y, the rest "
                         "unit-normal probes")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the solve into "
                         "DIR/trace.json, with the obs spans as regions")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="append a JSONL metrics snapshot to PATH on exit")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    owns_group = not dist.is_initialized()
    dev = init_distributed(args.device)
    mesh = make_host_mesh(device=dev)
    lead = dist.get_rank() == 0
    n_shards = mesh.data

    xtr, ytr, xte, yte = make_regression_dataset(args.dataset, args.seed,
                                                 scale=args.scale)
    n_tr, n_te, d = xtr.shape[0], xte.shape[0], xtr.shape[1]
    if args.num_rhs > 1:
        # column 0 is the real target; the probes ride the same matvecs
        probes = np.random.default_rng(args.seed + 2).standard_normal(
            (n_tr, args.num_rhs - 1)).astype(np.float32)
        ytr = np.concatenate([ytr[:, None], probes], axis=1)
    # padded rows: y = 0 -> beta ~ 0; padded queries are cut off below
    xtr, ytr, xte_p = (_pad_to(a, n_shards) for a in (xtr, ytr, xte))
    table = args.table_size or (
        1 << max(10, (4 * xtr.shape[0] - 1).bit_length()))
    cfg = KRRStepConfig(m=args.m, table_size=table, lam=args.lam,
                        cg_iters=args.cg_iters, fused=args.fused,
                        blocked_split=args.blocked_split,
                        precond=args.precond,
                        precond_rank=args.precond_rank,
                        overflow=args.overflow)
    f = get_bucket_fn(args.bucket)
    lsh = local_lsh(mesh, sample_lsh_params(
        np.random.default_rng(args.seed + 1), args.m, d, GammaPDF(2.0, 1.0),
        args.lengthscale))
    x, y, xq = (local_tensor(mesh, a) for a in (xtr, ytr, xte_p))

    if args.trace_dir and not obs.start_trace(args.trace_dir) and lead:
        print("[krr] --trace-dir ignored: torch.profiler unavailable")
    t0 = time.perf_counter()
    if args.table_mode == "hashjoin":
        # the resilient runner applies --overflow to the step's counters
        # and retries a non-finite solve once on an f32 wire
        wire = WIRE_DTYPES[args.wire_dtype]
        predict = make_krr_predict_hashjoin(mesh, cfg, f,
                                            cap_factor=args.cap_factor,
                                            payload_dtype=wire)
        beta, resnorm, tables, stats = run_krr_step_resilient(
            mesh, cfg, f, x, y, lsh, cap_factor=args.cap_factor,
            payload_dtype=wire)
        dropped = int(stats.overflow_dropped)
        if dropped and lead:
            print(f"[krr] hashjoin dropped {dropped} bucket(s) past "
                  f"capacity (policy={args.overflow})")
    else:
        predict = make_krr_predict(mesh, cfg, f)
        with obs.span("train.solve", {"table_mode": args.table_mode}):
            beta, resnorm, tables = make_krr_step(mesh, cfg, f)(x, y, lsh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    t_fit = time.perf_counter() - t0
    if args.trace_dir and obs.stop_trace() and lead:
        print(f"[krr] profiler trace -> {args.trace_dir}/trace.json")
    yhat = predict(xq, lsh, tables)
    if args.num_rhs > 1:
        yhat, resnorm = yhat[:, 0], resnorm[0]
    # squared error over my real query rows, summed over the data ranks
    n_loc = xq.shape[0]
    rows = torch.arange(n_loc, device=dev) + mesh.data_rank * n_loc
    yq = torch.from_numpy(_pad_to(yte, n_shards)).to(dev)[rows]
    sse = torch.where(rows < n_te, (yhat - yq) ** 2, 0.0).sum()
    dist.all_reduce(sse, group=mesh.data_group)
    rmse = float(torch.sqrt(sse / n_te))
    if lead:
        print(f"[krr] {args.dataset} scale={args.scale}: n={n_tr} d={d} "
              f"m={args.m} B={table} device={dev} fused={args.fused} "
              f"precond={args.precond} num_rhs={args.num_rhs} "
              f"table_mode={args.table_mode} wire={args.wire_dtype}")
        print(f"[krr] fit {t_fit:.2f}s on {mesh.size} rank(s) "
              f"({mesh.data} data x {mesh.model} model); CG residual "
              f"{float(resnorm):.2e}; test RMSE {rmse:.4f} (label std = 1.0)")
        _print_solve_metrics(args)
    if args.metrics_dump and lead:
        obs.REGISTRY.write_jsonl(args.metrics_dump,
                                 extra={"driver": "krr_train",
                                        "dataset": args.dataset})
        print(f"[krr] metrics snapshot -> {args.metrics_dump}")
    if owns_group:
        dist.destroy_process_group()
    return 0


def _print_solve_metrics(args) -> None:
    """Per-solve telemetry off the obs registry and spans."""
    span = ("dist.krr_step" if args.table_mode == "hashjoin"
            else "train.solve")
    st = obs.span_stats(span)
    if st["count"]:
        print(f"[krr] obs: span {span} x{st['count']} "
              f"p50 {st['p50_us']/1e3:.1f}ms max {st['max_us']/1e3:.1f}ms")
    if args.table_mode == "hashjoin":
        snap = obs.REGISTRY.snapshot()

        def _val(name, default=0.0):
            fam = snap.get(name)
            if not fam or not fam.get("series"):
                return default
            return fam["series"][0].get("value", default)

        print(f"[krr] obs: hashjoin routing builds "
              f"{_val('hashjoin_routing_builds_total'):.0f}, route cap "
              f"{_val('hashjoin_route_cap'):.0f} (owner max "
              f"{_val('hashjoin_route_owner_max'):.0f}), a2a payload "
              f"{_val('hashjoin_a2a_payload_bytes')/1e6:.2f} MB, overflow "
              f"dropped {_val('hashjoin_overflow_dropped_total'):.0f}, wire "
              f"retries {_val('dist_wire_retry_total'):.0f}")


if __name__ == "__main__":
    raise SystemExit(main())
