"""Run the distributed step and sharded serving on a small CPU process
group, one process per rank (gloo, ``torch.multiprocessing.spawn``, a file
store): the harness of the multi-rank tests.  Torch and the port only, so
the spawned processes never load JAX.

``spawn_ranks`` hands every rank the same global inputs (numpy), lets
each cut its own shards as the (data, model) grid says, runs the
jobs in order and returns each rank's results; ``assemble`` puts the
per-rank pieces back together into global arrays.  A ``serve`` job runs
every sharded-serving check of one grid in the same spawn
(``_serve_job``): rank 0 drives the ``ShardedPredictor`` sessions and
records what it served, the other ranks run the worker loop.  An ``lm``
job serves the LMs on the grid (``_lm_job``): each rank's prefill and
decode logits, its parameter bytes, its cache blocks, the MoE dispatch
and the collectives of a step.  A ``train`` job runs the train step on the
grid (``_train_job``): each rank's loss, gradient and AdamW blocks, the
collectives of a step and what the checkpointed functions saved; a
``train_grids`` job runs it on several grids in one spawn, each over the
first ranks of the group.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WIRES = {"f32": torch.float32, "bf16": torch.bfloat16}


def spawn_ranks(world_size: int, model_parallel: int, store_dir: str,
                inputs: dict, jobs: list, device: str = "cpu",
                backend: str | None = None,
                timeout_s: float | None = None,
                pods: int = 1) -> list[dict]:
    """Run ``jobs`` on a (world_size // model_parallel, model_parallel)
    grid.  ``inputs``: x, y, xq (numpy, global) and w, z,
    r1, r2 (global LSH rows).  ``jobs``: (name, spec) pairs, spec a dict
    with 'mode' ('psum' | 'hashjoin' | 'serve'); for the steps 'cfg'
    (KRRStepConfig fields), for the hash join 'wire' ('f32' | 'bf16') and
    optionally 'cap_factor'; for 'serve' the artifact
    directories ``_serve_job`` reads, for 'serve_rows' a 'grid' and the
    rows 'xq' to serve, for 'serve_faults' what ``_serve_faults_job``
    reads, for 'compressed_psum' the per-rank rows 'x' and a 'seed'.
    ``device`` is every rank's ("cuda:0": ranks sharing one card,
    over ``backend`` gloo); ``timeout_s`` the group's collective timeout
    (None: the backend's); ``pods`` the grid's pods (``make_host_mesh``).
    A 'prefill' job runs ``_prefill_job``."""
    mp.spawn(_rank_main, args=(world_size, model_parallel, store_dir, inputs,
                               jobs, device, backend, timeout_s, pods),
             nprocs=world_size, join=True)
    # the ranks' own results (tensors and numpy records): not weights
    return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                       weights_only=False)
            for r in range(world_size)]


def kv_heads_read(lay) -> dict:
    """{attention of a ``models.sharded.GridLayout`` ('slot0.attn',
    'shared.attn', 'encoder.attn', ...): the kv heads its local query heads
    read, ``Attn.kv_index`` as a list (None: its own)}."""
    from ..models.sharded import Attn
    plans = {f"{slot}.{k}": p for slot, ps in lay.slots.items()
             for k, p in ps.items() if isinstance(p, Attn)}
    if lay.shared is not None:
        plans["shared.attn"] = lay.shared
    plans.update({f"encoder.{k}": p for k, p in (lay.encoder or {}).items()
                  if isinstance(p, Attn)})
    return {k: None if p.kv_index is None else p.kv_index.tolist()
            for k, p in plans.items()}


def _rank_main(rank, world_size, model_parallel, store_dir, inputs, jobs,
               device="cpu", backend=None, timeout_s=None, pods=1):
    from ..core.bucket_fns import RECT
    from ..core.lsh import lsh_params_from_numpy
    from ..launch.mesh import (init_distributed, local_lsh, local_tensor,
                               make_host_mesh)
    torch.set_num_threads(1)
    dev = init_distributed(device, init_method=f"file://{store_dir}/store",
                           rank=rank, world_size=world_size, backend=backend,
                           timeout_s=timeout_s)
    mesh = make_host_mesh(model_parallel, device=dev, pods=pods)
    if "w" in inputs:
        lsh = local_lsh(mesh, lsh_params_from_numpy(
            inputs["w"], inputs["z"], inputs["r1"], inputs["r2"], "cpu"))
        x, y, xq = (local_tensor(mesh, inputs[k]) for k in ("x", "y", "xq"))
    out = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
    for name, spec in jobs:
        if spec["mode"] == "lm":
            out[name] = _lm_job(mesh, spec)
            continue
        if spec["mode"] == "prefill":
            out[name] = _prefill_job(mesh, spec)
            continue
        if spec["mode"] == "train":
            out[name] = _train_job(mesh, spec)
            continue
        if spec["mode"] == "collectives":
            out[name] = _collectives_job(mesh)
            continue
        if spec["mode"] == "train_grids":
            out[name] = _train_grids_job(spec)
            continue
        if spec["mode"] == "serve_cli":
            out[name] = _cli_job("serve", spec["argv"])
            continue
        if spec["mode"] == "serve":
            out[name] = _serve_job(mesh, spec)
            continue
        if spec["mode"] == "krr_serve":
            out[name] = _cli_job("krr_serve", spec["argv"])
            continue
        if spec["mode"] == "serve_rows":
            out[name] = _serve_rows_job(mesh, spec)
            continue
        if spec["mode"] == "serve_faults":
            out[name] = _serve_faults_job(mesh, spec)
            continue
        if spec["mode"] == "compressed_psum":
            out[name] = _compressed_psum_job(spec)
            continue
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


def _lm_job(mesh, spec) -> dict:
    """The LMs on this grid.  ``spec['cases']``: dicts of 'cfg', the
    global numpy 'params', 'tokens' (B, S), the decode steps' tokens
    'steps' (B, n), 'max_cache_len', 'gen' and, for whisper and a VLM, the
    global numpy 'source' ({'frames': ...} or {'patches': ...}).  For each
    case: this rank's rows of the forward's hidden states ('hidden',
    through ``model.forward(mesh=)``), of the prefill and of each decode
    step's logits, gathered over the vocab ('prefill', 'decode'), its rows
    ('rows'), its parameter bytes and blocks' shapes, its cache blocks'
    shapes, the kv heads
    the query heads of its first attention read, the collectives of the
    prefill and of each step, ``generate``'s global ids over 'gen' tokens
    and its own logits; for a MoE config the dispatch maps (tok_map,
    w_map) of each MoE call of the prefill, in order ('dispatch').  Also
    the ranks of the two groups, the cross-rank argmax of ``spec['ties']``
    (global (B, V) logits with planted ties across vocab blocks, cut by
    ``spec['ties_case']``'s layout), and for each case named in
    ``spec['ckpts']`` ({case name: a checkpoint of its parameters}) the
    blocks ``restore_resharded`` gives by ``param_shardings`` and whether
    they are exactly ``local_lm_params``' blocks ('restored',
    'restored_equal', by case name)."""
    from ..convert import local_lm_params
    from ..launch.serve import generate
    from ..launch.specs import param_shardings
    from ..models import model as TM
    from ..models import moe, sharded
    from ..models.params import tree_leaves, tree_map
    from ..sharding import (collective_counts, local_block,
                            reset_collective_counts)
    res = {"groups": (dist.get_process_group_ranks(mesh.data_group),
                      dist.get_process_group_ranks(mesh.model_group)),
           "cases": {}}
    real_dispatch = moe._dispatch_row
    for case in spec["cases"]:
        cfg = case["cfg"]
        lay = sharded.GridLayout(cfg, mesh)
        params = local_lm_params(case["params"], cfg, mesh, device="cpu")
        tokens = torch.from_numpy(case["tokens"]).long()
        steps = torch.from_numpy(case["steps"]).long()
        source = {k: torch.from_numpy(v)
                  for k, v in case.get("source", {}).items()}
        b, s = tokens.shape
        rows = local_block(np.arange(b), lay.rows_spec(b, s)[:1], mesh)
        out = {"rows": rows, "param_bytes": sum(
            t.numel() * t.element_size() for _, t in tree_leaves(params)),
            "param_shapes": {path: tuple(t.shape)
                             for path, t in tree_leaves(params)},
            "kv_heads": kv_heads_read(lay), "decode": [], "collectives": [],
            "dispatch": []}

        def recording(logits, e, k, cap):
            maps = real_dispatch(logits, e, k, cap)
            out["dispatch"].append((maps[0].numpy(), maps[1].numpy()))
            return maps
        with torch.inference_mode():
            out["hidden"] = TM.forward(cfg, params,
                                       {"tokens": tokens, **source},
                                       dtype=torch.float32,
                                       mesh=mesh)[0].numpy()
            reset_collective_counts()
            moe._dispatch_row = recording
            try:
                lg, cache, pos = sharded.prefill(
                    lay, params, {"tokens": tokens, **source},
                    max_cache_len=case["max_cache_len"], dtype=torch.float32)
            finally:
                moe._dispatch_row = real_dispatch
            out["collectives"].append(collective_counts())
            out["prefill"] = sharded.gather_logits(lay, lg).numpy()
            out["cache_shapes"] = {k: {n: tuple(t.shape) for n, t in v.items()}
                                   for k, v in cache.items()}
            for t in range(steps.shape[1]):
                reset_collective_counts()
                lg, cache = sharded.decode_step(
                    lay, params, cache, steps[torch.from_numpy(rows), t:t + 1], pos,
                    dtype=torch.float32)
                out["collectives"].append(collective_counts())
                out["decode"].append(sharded.gather_logits(lay, lg).numpy())
                pos = pos + 1
            kept = []
            ids, _, _ = generate(cfg, params, tokens, case["gen"],
                                 generator=torch.Generator(), mesh=mesh,
                                 logits=kept, source=source)
        out["generate"] = ids.numpy()
        out["generate_logits"] = [sharded.gather_logits(lay, lg).numpy()
                                  for lg in kept]
        res["cases"][case["name"]] = out
        if case["name"] in spec.get("ckpts", {}):
            from ..checkpoint import restore_resharded
            flat = dict(tree_leaves(param_shardings(cfg, mesh)))
            got, _, _ = restore_resharded(spec["ckpts"][case["name"]],
                                          case["params"], flat, mesh)
            res.setdefault("restored_equal", {})[case["name"]] = all(
                torch.equal(a, b) for (_, a), (_, b) in
                zip(tree_leaves(got), tree_leaves(params)))
            res.setdefault("restored", {})[case["name"]] = tree_map(
                lambda t: t.numpy(), got)
        if case["name"] == spec.get("ties_case"):
            ties_lay = lay
    if "ties" in spec:
        lay = ties_lay
        ties = torch.from_numpy(spec["ties"])
        block = local_block(ties, (None, "model" if lay.vocab_on else None),
                            mesh)
        res["ties"] = sharded.argmax(lay, block).numpy()
    return res


def _prefill_job(mesh, spec) -> dict:
    """The grid's prefill of ``spec``'s 'cfg', global numpy 'params' and
    'tokens' (float32): this rank's rows, their logits over the whole
    vocabulary, and the ranks of ``sharding.group_of`` along each axis."""
    from ..convert import local_lm_params
    from ..models import sharded
    from ..sharding import group_of, local_block
    cfg = spec["cfg"]
    lay = sharded.GridLayout(cfg, mesh)
    params = local_lm_params(spec["params"], cfg, mesh, device="cpu")
    tokens = torch.from_numpy(spec["tokens"]).long()
    b, s = tokens.shape
    groups = {axis: dist.get_process_group_ranks(group_of(mesh, axis))
              for axis in ("data", "pod", "pod_data", "model")}
    with torch.inference_mode():
        lg, _, _ = sharded.prefill(lay, params, {"tokens": tokens},
                                   max_cache_len=s, dtype=torch.float32)
        logits = sharded.gather_logits(lay, lg).numpy()
    return {"rows": local_block(np.arange(b), lay.rows_spec(b, s)[:1], mesh),
            "logits": logits, "groups": groups,
            "axis_sizes": mesh.axis_sizes}


def _collectives_job(mesh) -> dict:
    """Each autograd-visible collective of ``repro_torch.sharding`` over
    this grid's model group, on float64 inputs drawn from the rank: for
    ``reduce_sum``, ``gather_dim`` (dim 1) and ``keep_block`` (dim 1 by
    'model'), <f(x), y> and <x, f^T(y)> on this rank (f^T(y) the gradient
    autograd gives x for sum(f(x) * y)), the output's shape and the
    collectives counted in the forward and in the backward; and under
    ``inference_mode`` the untracked calls each made ('inference': the
    names of ``all_reduce_`` / ``all_gather_dim`` as called, and whether
    any output has a grad_fn)."""
    from .. import sharding as S
    gen = torch.Generator().manual_seed(1000 + dist.get_rank())
    group, m = mesh.model_group, mesh.model
    fns = {"reduce_sum": (lambda x: S.reduce_sum(x, group), (3, 5)),
           "gather_dim": (lambda x: S.gather_dim(x, 1, group), (3, 2, 4)),
           "keep_block": (lambda x: S.keep_block(x, (None, "model"), mesh),
                          (3, 2 * m))}
    res = {}
    for name, (f, shape) in fns.items():
        x = torch.randn(shape, generator=gen,
                        dtype=torch.float64).requires_grad_(True)
        S.reset_collective_counts()
        out = f(x)
        forward = S.collective_counts()
        y = torch.randn(out.shape, generator=gen, dtype=torch.float64)
        S.reset_collective_counts()
        (out * y).sum().backward()
        res[name] = dict(fx_y=float((out.detach() * y).sum()),
                         x_fty=float((x.detach() * x.grad).sum()),
                         shape=tuple(out.shape), forward=forward,
                         backward=S.collective_counts())
    calls, real = [], (S.all_reduce_, S.all_gather_dim)

    def named(fn):
        def call(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return call
    S.all_reduce_, S.all_gather_dim = named(real[0]), named(real[1])
    try:
        with torch.inference_mode():
            x = torch.randn((3, 4), generator=gen)
            outs = [S.reduce_sum(x, group), S.gather_dim(x, 0, group),
                    S.gather_at_use(x, ("model", None), [0], mesh),
                    S.keep_block(torch.randn((2 * m, 2), generator=gen),
                                 ("model", None), mesh)]
    finally:
        S.all_reduce_, S.all_gather_dim = real
    res["inference"] = dict(calls=calls, grad_fn=any(
        o.grad_fn is not None for o in outs))
    return res


def _numpy_tree(tree):
    from ..models.params import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def _train_grids_job(spec) -> dict:
    """``_train_job`` on each grid of ``spec['grids']`` ({(data, model):
    its cases}, in order), each over the first data x model ranks of the
    process group while the others wait: one spawn for several grids.
    Returns {grid: this rank's ``_train_job`` result with its data and
    model rank, or None where the rank is outside the grid}."""
    from ..launch.mesh import make_host_mesh
    out = {}
    for (d, m), cases in spec["grids"].items():
        mesh = make_host_mesh(m, ranks=range(d * m))
        out[d, m] = None if mesh is None else _train_job(
            mesh, {"cases": cases}) | {"data_rank": mesh.data_rank,
                                       "model_rank": mesh.model_rank}
    return out


def _recorded_step(mesh, cfg, opt_cfg, dtype, nm, params, batch) -> dict:
    """One ``make_train_step(mesh=)`` from ``params`` and a fresh AdamW
    state, recording on the way: the gradient AdamW is given ('grads'),
    the shapes each checkpointed function of the forward saved for its
    backward, by name in call order ('saved', through
    ``saved_tensors_hooks``), the token rows each loss ran on this rank
    ('tokens') and the collectives by kind, forward, backward and the
    optimizer's ('collectives'); then the step's metrics, new parameter,
    m and v blocks and step count."""
    from ..launch import steps
    from ..models import sharded
    from ..optim import adamw_init
    from ..sharding import (collective_counts, local_block,
                            reset_collective_counts)
    out = {"saved": [], "tokens": []}
    real = (sharded.checkpoint, sharded.loss_fn, steps.adamw_update)

    def checkpoint(fn, *args, **kw):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            got = real[0](fn, *args, **kw)
        out["saved"].append((fn.__name__, shapes))
        return got

    def loss_fn(lay, p, mb, **kw):
        out["tokens"].append(local_block(mb["tokens"], lay.rows_spec(
            *mb["tokens"].shape), mesh).numpy())
        return real[1](lay, p, mb, **kw)

    def adamw_update(opt, grads, *args, **kw):
        out["grads"] = _numpy_tree(grads)
        return real[2](opt, grads, *args, **kw)
    sharded.checkpoint, sharded.loss_fn, steps.adamw_update = (
        checkpoint, loss_fn, adamw_update)
    reset_collective_counts()
    try:
        p1, o1, m1 = steps.make_train_step(cfg, opt_cfg, dtype, nm,
                                           mesh=mesh)(
            params, adamw_init(params), batch)
    finally:
        sharded.checkpoint, sharded.loss_fn, steps.adamw_update = real
    out.update(collectives=collective_counts(), metrics=_metrics(m1),
               params=_numpy_tree(p1), m=_numpy_tree(o1.m),
               v=_numpy_tree(o1.v), count=int(o1.step))
    return out


def _train_job(mesh, spec) -> dict:
    """The train step on this grid.  ``spec['cases']``: dicts of 'name',
    'cfg', the global numpy 'params', the global numpy 'batch' (tokens,
    labels and, for whisper and a VLM, frames or patches), 'dtype' ('f32'
    or 'bf16'), 'opt' (``AdamWConfig`` fields) and optionally
    'microbatches' (counts past 1 to run as well), 'witness' (True: also
    the gradient without its sum over 'data'), 'state' (a checkpoint
    directory of a one-process ``{"params", "opt"}`` train state drawn by
    ``init_train_state`` from 'seed').  For each case, this rank's: rows;
    one train step from ``local_lm_params``' blocks and a fresh AdamW
    state, ``_recorded_step``'s record ('step'); the metrics of
    ``model.loss_fn(mesh=)`` without autograd ('eval'); per microbatch
    count the same record ('micro'); with 'witness', the gradient whose
    leaves replicated over 'data' miss their sum there
    ('grads_without_data_sum'); with 'state', ``_train_state_check``'s
    record."""
    from ..convert import local_lm_params
    from ..launch import steps
    from ..models import model as TM
    from ..models import sharded
    from ..optim import AdamWConfig
    from ..sharding import local_block
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    res = {"cases": {}}
    for case in spec["cases"]:
        cfg, dtype = case["cfg"], dtypes[case["dtype"]]
        opt_cfg = AdamWConfig(**case["opt"])
        params = local_lm_params(case["params"], cfg, mesh, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        b, s = batch["tokens"].shape
        lay = sharded.GridLayout(cfg, mesh)
        out = {"rows": local_block(np.arange(b), lay.rows_spec(b, s)[:1],
                                   mesh),
               "step": _recorded_step(mesh, cfg, opt_cfg, dtype, 1, params,
                                      batch),
               "micro": {nm: _recorded_step(mesh, cfg, opt_cfg, dtype, nm,
                                            params, batch)
                         for nm in case.get("microbatches", ())}}
        with torch.no_grad():
            out["eval"] = _metrics(TM.loss_fn(cfg, params, batch, dtype=dtype,
                                              mesh=mesh)[1])
        if case.get("witness"):
            real_axes = steps.unnamed_axes
            steps.unnamed_axes = lambda spec, *mesh: tuple(
                a for a in real_axes(spec, *mesh) if a != "data")
            try:
                out["grads_without_data_sum"] = _numpy_tree(
                    steps.make_grad_step(cfg, dtype, mesh=mesh)(params,
                                                                batch)[1])
            finally:
                steps.unnamed_axes = real_axes
        if "state" in case:
            out["state"] = _train_state_check(mesh, cfg, case, opt_cfg,
                                              dtype, batch)
        res["cases"][case["name"]] = out
    return res


def _train_state_check(mesh, cfg, case, opt_cfg, dtype, batch) -> dict:
    """A one-process train state's checkpoint (``case['state']``, drawn
    from ``case['seed']``) restored on this rank by ``param_shardings``
    and ``opt_shardings`` against ``init_train_state(mesh=)``'s blocks of
    the same draws: whether they are equal leaf by leaf ('restored_equal')
    and so is one step from each ('steps_equal'), the bytes of the
    parameter, m, v and step blocks held ('held') and ``shard_bytes``'
    columns for this batch's train cell ('shard_bytes')."""
    from ..checkpoint import restore_resharded
    from ..configs.base import ShapeSpec
    from ..launch import specs, steps
    from ..models.params import tree_leaves
    own = steps.init_train_state(
        cfg, torch.Generator().manual_seed(case["seed"]), mesh=mesh)
    got, _, _ = restore_resharded(
        case["state"], specs.abstract_train_state(cfg),
        specs.train_state_placement(cfg, mesh), mesh)
    got = (got["params"], got["opt"])

    def leaves(params, opt):
        return tree_leaves({"p": params, "m": opt.m, "v": opt.v}) + [
            ("step", opt.step)]

    def equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    step = steps.make_train_step(cfg, opt_cfg, dtype, mesh=mesh)
    after = [step(*state, batch) for state in (got, own)]
    b, s = batch["tokens"].shape
    return dict(
        restored_equal=equal(leaves(*got), leaves(*own)),
        steps_equal=equal(leaves(*after[0][:2]), leaves(*after[1][:2]))
        and all(torch.equal(after[0][2][k], after[1][2][k])
                for k in after[0][2]),
        held=sum(t.numel() * t.element_size() for _, t in leaves(*own)),
        shard_bytes=specs.shard_bytes(cfg, ShapeSpec("train", s, b, "train"),
                                      mesh))


def _compressed_psum_job(spec) -> dict:
    """``optim.compressed_psum`` of this rank's row of spec['x'] (world,
    ...) over the world group, its generator seeded with spec['seed']."""
    from ..optim import compressed_psum
    x = torch.from_numpy(spec["x"][dist.get_rank()])
    return {"sum": compressed_psum(x, dist.group.WORLD,
                                   torch.Generator().manual_seed(
                                       spec["seed"]))}


def _serve_job(mesh, spec) -> dict:
    """Every sharded-serving check of one grid, in sessions: each session
    builds a ``ShardedPredictor`` on every rank; rank 0 runs the session's
    checks and stops the grid, the other ranks serve until then.  Returns,
    on rank 0, what it served and saw (numpy), for the test to hold
    against the port's and the JAX package's ``Predictor``; {} elsewhere.

    ``spec``: 'grid', 'grid_norm', 'grid_k3' (sharded exports for this
    grid), 'flat', 'flat_norm', 'flat_k3' (the same models flat), 'flat_b'
    (a second model, flat), 'half' (model 'flat' exported for one model
    rank: placement co-serving), 'root' (an empty version root), 'xq'."""
    from ..serve import ShardedPredictor
    front = dist.get_rank() == 0
    mm, nd = mesh.model, mesh.data
    res = {}
    sessions = [("bcast", dict(cache_entries=1024)),
                ("dedup", dict(dedup=True, max_batch=16)),
                ("starved", dict(dedup=True, cap_factor=0.001)),
                ("lifecycle", dict(cache_entries=1024, max_batch=16))]
    for name, kw in sessions:
        pred = ShardedPredictor(mesh=mesh, **kw)
        if front:
            try:
                _SESSIONS[name](pred, spec, res, mm, nd)
            finally:
                pred.stop()
        else:
            pred.serve_forever()
        if name == "bcast":
            # the first model loaded ("grid", handle 0): this rank's piece
            share = pred._handles[0].share
            res["pieces"] = dict(piece=(mesh.model_rank, mesh.data_rank),
                                 table=share.table.cpu().numpy(),
                                 w=share.lsh.w.cpu().numpy())
    return res


def _serve_rows_job(mesh, spec) -> dict:
    """Rank 0 loads ``spec['grid']`` and serves ``spec['xq']`` in both
    routes, the others serve; rank 0's answers and every rank's launch
    counts."""
    from ..kernels import launch_counts, reset_launch_counts
    from ..serve import ShardedPredictor
    res = {}
    reset_launch_counts()
    for dedup in (False, True):
        pred = ShardedPredictor(mesh=mesh, max_batch=64, dedup=dedup)
        if pred.is_front:
            try:
                pred.load(spec["grid"])
                res[f"pred_dedup{int(dedup)}"] = pred.predict(
                    spec["xq"], use_cache=False)
            finally:
                pred.stop()
        else:
            pred.serve_forever()
    res["counts"] = launch_counts()
    return res


def _serve_faults_job(mesh, spec) -> dict:
    """The two ways a grid could hang, on a group whose collective timeout
    is short: rank 0 idles for ``spec['idle_s']`` (past the timeout; the
    heartbeat, every ``spec['heartbeat_s']``, keeps each worker's wait
    short) and serves again; then the last rank's local half of a predict
    raises (model 'bad': its piece's LSH rows lack a column) and rank 0's
    predict must raise that rank's error, after which the grid serves the
    good model again.  Every rank hosts both models through ``add_model``
    (its own piece of ``spec['grid']``).  Returns rank 0's answers and
    error text, and each worker's last error."""
    import time

    from ..errors import ServingError
    from ..serve import ShardedPredictor, load_artifact_piece
    rank, world = dist.get_rank(), dist.get_world_size()
    pred = ShardedPredictor(mesh=mesh, heartbeat_s=spec["heartbeat_s"])
    piece = load_artifact_piece(
        spec["grid"], mesh_shape=(mesh.model, mesh.data),
        piece=(mesh.model_rank, mesh.data_rank), device="cpu",
        with_lsh_host=pred.is_front)
    pred.add_model(piece, artifact_id="good")
    if rank == world - 1:
        piece = piece._replace(lsh=type(piece.lsh)(
            *(t[:, :-1].contiguous() for t in piece.lsh)))
    pred.add_model(piece, artifact_id="bad")
    res = {}
    if not pred.is_front:
        pred.serve_forever()
        return {"worker_error": pred.health()["last_error"]}
    xq = spec["xq"]
    try:
        res["before"] = pred.predict(xq, artifact_id="good", use_cache=False)
        time.sleep(spec["idle_s"])
        res["after_idle"] = pred.predict(xq, artifact_id="good",
                                         use_cache=False)
        try:
            pred.predict(xq, artifact_id="bad", use_cache=False)
            res["fault"] = None
        except ServingError as e:
            res["fault"] = str(e)
        res["after_fault"] = pred.predict(xq, artifact_id="good",
                                          use_cache=False)
        res["errors"] = pred.health()["errors"]
    finally:
        pred.stop()
    return res


def _cli_job(module: str, argv) -> dict:
    """``launch.<module>.main(argv)`` (``krr_serve``: rank 0 fronts, the
    others serve; ``serve``: every rank of a ``--mesh`` grid) on every rank
    of the running group; each rank's standard output is kept."""
    import contextlib
    import io

    from ..launch import krr_serve, serve
    cli = {"krr_serve": krr_serve, "serve": serve}[module]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "out": buf.getvalue()}


def _bcast_session(pred, spec, res, mm, nd):
    from ..errors import InvalidRequest
    from ..serve import Predictor
    xq = spec["xq"]
    single = Predictor(device="cpu")
    for tag in ("", "_norm", "_k3"):
        aid = pred.load(spec["grid" + tag], artifact_id="grid" + tag)
        single.load(spec["flat" + tag], artifact_id="flat" + tag)
        res["pred" + tag] = pred.predict(xq, artifact_id=aid,
                                         use_cache=False)
        res["single" + tag] = single.predict(xq, artifact_id="flat" + tag,
                                             use_cache=False)
        res["one_row" + tag] = pred.predict(xq[0], artifact_id=aid,
                                            use_cache=False)
    if mm == 1:
        try:
            pred.load(spec["half"], artifact_id="placed", placement=(1, 2))
            res["placement_refused"] = False
        except ValueError:
            res["placement_refused"] = "placed" not in pred.artifact_ids
    else:
        # a one-model-rank export on model rows [1, 2) against itself on
        # rows [0, 1): both serve through one model rank
        pred.load(spec["half"], artifact_id="placed", placement=(1, 2))
        pred.load(spec["half"], artifact_id="placed0", placement=(0, 1))
        res["placed"] = pred.predict(xq, artifact_id="placed",
                                     use_cache=False)
        res["placed0"] = pred.predict(xq, artifact_id="placed0",
                                      use_cache=False)
        res["placement"] = pred.health()["shards"]["placed"]["placement"]
    # cache: hits replay the cold rows; a bump misses exactly the rows whose
    # slots touch the bumped shard
    q = xq[:16]
    cold = pred.predict(q, artifact_id="grid")
    res["cache_hit_equal"] = np.array_equal(
        pred.predict(q, artifact_id="grid"), cold)
    before = pred.cache_stats(artifact_id="grid")
    pred.bump_shard_version(0, artifact_id="grid")
    res["cache_after_bump_equal"] = np.array_equal(
        pred.predict(q, artifact_id="grid"), cold)
    after = pred.cache_stats(artifact_id="grid")
    res["bump_misses"] = after["misses"] - before["misses"]
    res["bump_hits"] = after["hits"] - before["hits"]
    hosted = pred._hosted("grid")
    touch = hosted.keyfn.keys_with_touch(
        q, table_size=int(hosted.manifest["table_size"]), n_shards=nd)
    res["touch0"] = sum(0 in t for _, t in touch)
    res["piece_versions"] = pred.health()["shards"]["grid"]["piece_versions"]
    bad = xq[:4].copy()
    bad[1, 2] = np.nan
    errors = pred.health()["errors"]
    try:
        pred.predict(bad, artifact_id="grid")
        res["nonfinite_rejected"] = False
    except InvalidRequest:
        res["nonfinite_rejected"] = pred.health()["errors"] == errors + 1
    # ragged sizes within one bucket run no new bucket
    res["buckets_before"] = sorted(hosted.buckets)
    for b in (9, 12, 16, 3, 1):
        pred.predict(xq[:b], artifact_id="grid", use_cache=False)
    res["buckets_after"] = sorted(hosted.buckets)
    res["overflow_bcast"] = pred.health()["shards"]["grid"]["overflow"]
    res["unloaded"] = pred.unload("grid_k3") and "grid_k3" not in \
        pred.artifact_ids


def _dedup_session(pred, spec, res, mm, nd):
    pred.load(spec["grid"], artifact_id="grid")
    res["dedup_chunked"] = pred.predict(spec["xq"][:50], use_cache=False)
    res["overflow_dedup"] = pred.health()["shards"]["grid"]["overflow"]


def _starved_session(pred, spec, res, mm, nd):
    pred.load(spec["grid"], artifact_id="grid")
    pred.predict(spec["xq"], use_cache=False)
    res["overflow_starved"] = pred.health()["shards"]["grid"]["overflow"]


def _lifecycle_session(pred, spec, res, mm, nd):
    """v1 served; v2 with one piece scaled on disk (canary reject); v3
    torn (pieces, no manifest: invisible); v4 with a NaN piece and v5 with
    a piece of the previous export (both refused at load, on the rank
    that reads the piece); v6, another model, swapped in; rollback() to
    v1."""
    from ..serve import (LifecycleConfig, ServingRuntime, export_artifact_sharded,
                         load_artifact, version_dir)
    from .faults import (mixed_generation_publish, nan_piece, poison_piece,
                         torn_publish)
    root, xq = spec["root"], spec["xq"]
    shape = (mm, nd)
    models = [load_artifact(spec[k], device="cpu").model
              for k in ("flat", "flat_b")]
    rt = ServingRuntime(root, predictor=pred, config=LifecycleConfig(
        probation_s=0.0, retain=2, warm_sizes=(16,)))
    last = (mm - 1, nd - 1)
    steps = []

    def step(label, publish):
        publish()
        r = rt.poll_once()
        steps.append((label, r["action"], rt.active_version))

    def v(n):
        return version_dir(root, n)

    step("v1", lambda: export_artifact_sharded(v(1), models[0],
                                               mesh_shape=shape))
    res["life_v1"] = rt.predict(xq, use_cache=False)

    def poisoned():
        export_artifact_sharded(v(2), models[0], mesh_shape=shape)
        poison_piece(v(2), last)
    step("v2 poisoned piece", poisoned)
    step("v3 torn", lambda: torn_publish(v(3), models[1], mesh_shape=shape,
                                         after_saves=mm * nd))

    def nan():
        export_artifact_sharded(v(4), models[1], mesh_shape=shape)
        nan_piece(v(4), last)
    step("v4 nan piece", nan)
    step("v5 mixed generations", lambda: mixed_generation_publish(
        v(5), models[1], mesh_shape=shape, stale=last))
    step("v6", lambda: export_artifact_sharded(v(6), models[1],
                                               mesh_shape=shape))
    res["life_v6"] = rt.predict(xq, use_cache=False)
    res["life_models_v6"] = pred.artifact_ids
    ok = rt.rollback("test: rollback to v1")
    steps.append(("rollback()", "rollback" if ok else "refused",
                  rt.active_version))
    res["life_after_rollback"] = rt.predict(xq, use_cache=False)
    res["life_models"] = pred.artifact_ids
    res["life_steps"] = steps
    res["life_rejected"] = rt.health()["rejected_versions"]


_SESSIONS = {"bcast": _bcast_session, "dedup": _dedup_session,
             "starved": _starved_session, "lifecycle": _lifecycle_session}


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
