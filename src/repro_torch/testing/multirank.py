"""Run the distributed step on a small CPU process group, one process per
rank (gloo, ``torch.multiprocessing.spawn``, a file store): the harness of
the multi-rank tests.  Torch and the port only, so the spawned processes
never load JAX.

``spawn_ranks`` hands every rank the same global inputs (numpy), lets
each cut its own shards as the (data, model) grid says, runs the jobs in
order and returns each rank's results; ``assemble`` puts the per-rank
pieces back together into global arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WIRES = {"f32": torch.float32, "bf16": torch.bfloat16}


def spawn_ranks(world_size: int, model_parallel: int, store_dir: str,
                inputs: dict, jobs: list) -> list[dict]:
    """Run ``jobs`` on a (world_size // model_parallel, model_parallel)
    grid.  ``inputs``: x, y, xq (numpy, global) and w, z, r1, r2 (global
    LSH rows).  ``jobs``: (name, spec) pairs, spec a dict with 'mode'
    ('psum' | 'hashjoin'), 'cfg' (KRRStepConfig fields) and for the hash
    join 'wire' ('f32' | 'bf16') and optionally 'cap_factor'."""
    mp.spawn(_rank_main, args=(world_size, model_parallel, store_dir, inputs,
                               jobs), nprocs=world_size, join=True)
    return [torch.load(os.path.join(store_dir, f"rank{r}.pt"))
            for r in range(world_size)]


def _rank_main(rank, world_size, model_parallel, store_dir, inputs, jobs):
    from ..core.bucket_fns import RECT
    from ..core.lsh import lsh_params_from_numpy
    from ..launch.mesh import (init_distributed, local_lsh, local_tensor,
                               make_host_mesh)
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{store_dir}/store",
                     rank=rank, world_size=world_size)
    mesh = make_host_mesh(model_parallel, device="cpu")
    lsh = local_lsh(mesh, lsh_params_from_numpy(
        inputs["w"], inputs["z"], inputs["r1"], inputs["r2"], "cpu"))
    x, y, xq = (local_tensor(mesh, inputs[k]) for k in ("x", "y", "xq"))
    out = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
    for name, spec in jobs:
        out[name] = _run(mesh, spec, RECT, x, y, xq, lsh)
    torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _run(mesh, spec, f, x, y, xq, lsh) -> dict:
    from ..core import distributed as D
    cfg = D.KRRStepConfig(**spec["cfg"])
    if spec["mode"] == "psum":
        beta, resnorm, tables = D.make_krr_step(mesh, cfg, f)(x, y, lsh)
        pred = D.make_krr_predict(mesh, cfg, f)(xq, lsh, tables)
        return {"beta": beta, "resnorm": resnorm, "tables": tables,
                "pred": pred}
    wire = WIRES[spec["wire"]]
    cap = spec.get("cap_factor", 2.0)
    beta, resnorm, table, stats = D.make_krr_step_hashjoin(
        mesh, cfg, f, cap_factor=cap, payload_dtype=wire)(x, y, lsh)
    res = {"beta": beta, "resnorm": resnorm, "table": table,
           "dropped": stats.overflow_dropped,
           "nonfinite": stats.wire_nonfinite}
    for dedup in (True, False):
        pred, dropped = D.make_krr_predict_hashjoin(
            mesh, cfg, f, cap_factor=cap, payload_dtype=wire,
            with_stats=True, dedup=dedup)(xq, lsh, table)
        res[f"pred_dedup{int(dedup)}"] = pred
        res[f"pred_dropped{int(dedup)}"] = dropped
    return res


def assemble(results: list[dict], job: str, key: str) -> np.ndarray:
    """The global array of one result: beta and predictions concatenated
    over the data ranks; psum tables over the model ranks; hash-join
    tables over both (instances over model, slot ranges over data)."""
    grid = {(r["data_rank"], r["model_rank"]): r[job][key].numpy()
            for r in results}
    data = 1 + max(d for d, _ in grid)
    model = 1 + max(mm for _, mm in grid)
    if key == "table":
        return np.concatenate([np.concatenate([grid[d, mm]
                                               for d in range(data)], 1)
                               for mm in range(model)], 0)
    if key == "tables":
        return np.concatenate([grid[0, mm] for mm in range(model)], 0)
    if key.startswith("pred_dropped"):
        return np.concatenate([grid[d, 0] for d in range(data)])
    if grid[0, 0].ndim == 0 or key in ("dropped", "nonfinite"):
        return grid[0, 0]
    return np.concatenate([grid[d, 0] for d in range(data)])
