"""The dry run: every (architecture x input-shape) cell and the paper's KRR
step traced on rank 0 of the production mesh, with memory, FLOPs,
collectives and roofline terms a rank.  The port of ``repro.launch.dryrun``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells lm --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells krr --mesh multipod

The JAX dry run lowers and compiles each step for 512 placeholder CPU
devices.  Here one process is rank 0 of the 16x16 (or 2x16x16) grid
(``launch.mesh.make_production_mesh``: torch's fake process-group backend
for the other ranks): it builds its blocks of the parameters, the AdamW
state, the batch and the cache as meta tensors (shapes, no storage) by the
sharding rules, runs the port's own step on them under ``roofline.Tracer``
and reads the counts.  It needs no card and sets no ``XLA_FLAGS``.  There
is no ``--unroll``: the port's layer groups are a Python loop, never a
scan.

A row has the JAX row's keys (the ``Roofline`` row, the argument,
temporary and output bytes a device, collectives by kind) on the H100
constants of ``roofline``, with ``trace_s`` (the trace's wall time) for
``compile_s`` and ``xla_flops_per_dev`` the FLOPs with each scaled loop
body counted once (as XLA's ``cost_analysis`` counts a while body); and
``stand_ins`` (the meta stand-ins of host reads and data-dependent shapes,
with their call sites), ``kernel_credits`` (each hand-written kernel's
calls, FLOPs and bound bytes), ``host_reads`` (host reads a step) and
``flops_by_dtype``.  The bytes: arguments are rank 0's blocks of the
inputs; temporaries the trace's peak of live bytes less the outputs (what
is still alive when the step returns); ``bytes_per_device`` arguments plus
the peak.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch

from ..configs import registry
from ..configs.base import SHAPES
from ..configs.wlsh_krr import CONFIG as KRR_CONFIG, KRR_SHAPES
from ..core.bucket_fns import get_bucket_fn
from ..core.distributed import (KRRStepConfig, make_krr_step,
                                make_krr_step_hashjoin)
from ..core.lsh import LSHParams
from ..models import model
from ..models.params import tree_leaves, tree_map
from ..models.sharded import ShardedCache
from ..optim import AdamWConfig, adamw_init
from ..roofline import Tracer, analyze_trace
from ..sharding import local_shape, spec_for, tree_shardings
from .mesh import make_production_mesh
from .specs import (TRAIN_MICROBATCHES, batch_axes, batch_specs,
                    cache_shardings, decode_specs, param_shardings,
                    useful_flops)
from .steps import make_decode_step, make_prefill_step, make_train_step

META = torch.device("meta")


class Cell(NamedTuple):
    """One traced step: ``step(*args)`` on rank 0's meta blocks."""
    step: object
    args: tuple
    model_flops: float
    arg_bytes: int
    train: bool


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A fresh meta tensor of rank 0's block of ``t`` laid out by
    ``spec``."""
    return torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                       device=META)


def _blocks(tree, spec_tree, mesh):
    return tree_map(lambda t, sp: _block(t, sp, mesh), tree, spec_tree)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def lower_lm_cell(arch: str, shape, mesh, micro: int | None = None,
                  cfg=None, dtype=torch.bfloat16) -> Cell:
    """Rank 0's step of one LM cell (``shape``: a name of ``SHAPES`` or a
    ``ShapeSpec``): float32 parameters and their AdamW state for train,
    ``dtype`` (the compute dtype) parameters for prefill and decode, laid
    out by ``param_shardings`` (``cache_shardings`` for the decode cache);
    the global batch for train and prefill (the step cuts its rows), the
    rank's rows for decode.  ``cfg`` overrides the registry's config."""
    cfg = registry.get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mf = useful_flops(cfg, shape)
    if shape.kind == "train":
        nm = micro if micro is not None else TRAIN_MICROBATCHES.get(arch, 1)
        step = make_train_step(cfg, AdamWConfig(), dtype,
                               num_microbatches=nm, mesh=mesh)
        params = _blocks(model.abstract_params(cfg, torch.float32),
                         param_shardings(cfg, mesh), mesh)
        opt = adamw_init(params)
        batch = batch_specs(cfg, shape)
        local = tree_shardings(batch_axes(cfg, shape), batch, mesh)
        arg = tree_bytes(params) + tree_bytes(opt.m) + tree_bytes(opt.v) \
            + opt.step.element_size() + sum(
            math.prod(local_shape(t.shape, local[k], mesh)) *
            t.element_size() for k, t in batch.items())
        return Cell(step, (params, opt, batch), mf, arg, True)
    params = _blocks(model.abstract_params(cfg, dtype),
                     param_shardings(cfg, mesh, dtype), mesh)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, max_cache_len=s, dtype=dtype,
                                 mesh=mesh)
        batch = batch_specs(cfg, shape)
        local = tree_shardings(batch_axes(cfg, shape), batch, mesh)
        arg = tree_bytes(params) + sum(
            math.prod(local_shape(t.shape, local[k], mesh)) *
            t.element_size() for k, t in batch.items())
        return Cell(step, (params, batch), mf, arg, False)
    step = make_decode_step(cfg, dtype, mesh=mesh)
    cache, tok, pos = decode_specs(cfg, shape, dtype)
    cache = ShardedCache(_blocks(cache, cache_shardings(cfg, shape, mesh),
                                 mesh), b, s)
    rows = spec_for(("batch", None), (b, 1), mesh)
    tok = _block(tok, rows, mesh)
    pos = _block(pos, rows[:1], mesh)
    arg = tree_bytes(params) + tree_bytes(dict(cache)) + tree_bytes(
        {"t": tok, "p": pos})
    return Cell(step, (params, cache, tok, pos), mf, arg, False)


def lower_krr_cell(shape_name: str, mesh, variant: str = "psum") -> Cell:
    """Rank 0's step of the paper's distributed KRR: its rows of x and y
    over the (pod, data) axes, its instances over 'model'.

    variant 'psum' is the paper-faithful baseline (dense CountSketch table
    merged with an all-reduce); 'hashjoin' the sharded table with the
    nonzero cells routed by all_to_all, at ``cap_factor`` 1.25 and the
    config's wire dtype (the JAX dry run's)."""
    spec = KRR_SHAPES[shape_name]
    n, m, b = spec["n_points"], spec["m"], spec["table_size"]
    d = KRR_CONFIG.dim
    cfg = KRRStepConfig(m=m, table_size=b, lam=KRR_CONFIG.lam,
                        cg_iters=KRR_CONFIG.cg_iters, fused=KRR_CONFIG.fused)
    f = get_bucket_fn(KRR_CONFIG.bucket)
    wire = torch.bfloat16 if KRR_CONFIG.wire_dtype == "bf16" \
        else torch.float32
    step = (make_krr_step_hashjoin(mesh, cfg, f, cap_factor=1.25,
                                   payload_dtype=wire)
            if variant == "hashjoin" else make_krr_step(mesh, cfg, f))
    n_loc, m_loc = n // mesh.data, m // mesh.model
    x = torch.empty((n_loc, d), dtype=torch.float32, device=META)
    y = torch.empty((n_loc,), dtype=torch.float32, device=META)
    lsh = LSHParams(*(torch.empty((m_loc, d), dtype=dt, device=META)
                      for dt in (torch.float32, torch.float32, torch.uint32,
                                 torch.uint32)))
    # useful FLOPs: per CG iter, featurized matvec = scatter + gather +
    # dots: ~6 flops per (instance, point); featurize ~10 a point
    mf = (cfg.cg_iters + 2) * (6.0 * m * n) + 10.0 * m * n
    arg = tree_bytes({"x": x, "y": y, "lsh": dict(lsh._asdict())})
    return Cell(step, (x, y, lsh), mf, arg, False)


def trace_cell(cell: Cell):
    """(Trace, bytes alive when the step returned) of one call of the
    cell's step under a ``Tracer``; inference mode for prefill, decode and
    the KRR step, as they are served and run."""
    grad = contextlib.nullcontext() if cell.train else torch.inference_mode()
    with grad, Tracer() as tracer:
        out = cell.step(*cell.args)
        out_bytes = tracer.trace.live_bytes
    del out
    return tracer.trace, out_bytes


def run_cell(kind: str, arch: str, shape_name: str, mesh, mesh_name: str,
             micro: int | None = None, krr_variant: str = "psum") -> dict:
    t0 = time.time()
    if kind == "krr":
        cell = lower_krr_cell(shape_name, mesh, krr_variant)
        suffix = "" if krr_variant == "psum" else f"+{krr_variant}"
        name = f"wlsh_krr{suffix}/{shape_name}/{mesh_name}"
    else:
        cell = lower_lm_cell(arch, shape_name, mesh, micro)
        name = f"{arch}/{shape_name}/{mesh_name}"
    trace, out_bytes = trace_cell(cell)
    dt = time.time() - t0
    roof = analyze_trace(name, trace, chips=mesh.size,
                         model_flops=cell.model_flops,
                         arg_bytes=cell.arg_bytes)
    row = roof.row()
    row.update({
        "trace_s": round(dt, 1),
        "arg_bytes_per_device": int(cell.arg_bytes),
        "temp_bytes_per_device": int(trace.peak_bytes - out_bytes),
        "output_bytes_per_device": int(out_bytes),
        "collective_counts": {k: int(v["calls"]) for k, v in
                              sorted(trace.collectives.items())},
        "collective_bytes_by_op": {k: int(v["bytes"]) for k, v in
                                   sorted(trace.collectives.items())},
        "xla_flops_per_dev": trace.flops_once,
        "flops_by_dtype": dict(trace.flops_by_dtype),
        "kernel_credits": {k: dict(v) for k, v in
                           sorted(trace.kernels.items())},
        "host_reads": sum(trace.host_reads.values()),
        "stand_ins": list(trace.stand_ins),
    })
    print(f"[dryrun] {name}: trace {dt:.1f}s  "
          f"args/dev {row['arg_bytes_per_device']/1e9:.2f} GB  "
          f"temp/dev {row['temp_bytes_per_device']/1e9:.2f} GB  "
          f"flops {roof.hlo_flops:.3e}  coll {roof.collective_bytes/1e9:.3f} GB  "
          f"dominant={roof.dominant}  roofline_frac={roof.roofline_frac:.3f}",
          flush=True)
    return row


def iter_cells(cells: str, arch: str | None, shape: str | None):
    if cells in ("lm", "all"):
        for a in registry.ARCH_IDS:
            if arch and a != arch:
                continue
            for s in SHAPES:
                if shape and s != shape:
                    continue
                if not registry.runs_shape(a, s):
                    continue
                yield ("lm", a, s)
    if cells in ("krr", "all") and (arch in (None, "wlsh_krr")):
        for s in KRR_SHAPES:
            if shape and s != shape:
                continue
            yield ("krr", "wlsh_krr", s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--cells", default="all", choices=["lm", "krr", "all"])
    ap.add_argument("--out", default=None, help="append-mode JSONL report")
    ap.add_argument("--micro", type=int, default=None,
                    help="override train microbatch count")
    ap.add_argument("--krr-variant", default="psum",
                    choices=["psum", "hashjoin"])
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("pod", "both"):
        meshes.append(("pod16x16", False))
    if args.mesh in ("multipod", "both"):
        meshes.append(("multipod2x16x16", True))

    failures = []
    for mesh_name, multi_pod in meshes:
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            for kind, a, s in iter_cells(args.cells, args.arch, args.shape):
                try:
                    row = run_cell(kind, a, s, mesh, mesh_name, args.micro,
                                   args.krr_variant)
                    if args.out:
                        os.makedirs(os.path.dirname(args.out) or ".",
                                    exist_ok=True)
                        with open(args.out, "a") as fh:
                            fh.write(json.dumps(row) + "\n")
                except Exception:
                    failures.append((mesh_name, a, s))
                    print(f"[dryrun] FAILED {a}/{s}/{mesh_name}")
                    traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILED cells: {failures}")
        return 1
    print("[dryrun] all requested cells traced OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
