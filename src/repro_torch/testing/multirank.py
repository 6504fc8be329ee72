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
and the collectives of a step.
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
                timeout_s: float | None = None) -> list[dict]:
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
    (None: the backend's)."""
    mp.spawn(_rank_main, args=(world_size, model_parallel, store_dir, inputs,
                               jobs, device, backend, timeout_s),
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
               device="cpu", backend=None, timeout_s=None):
    from ..core.bucket_fns import RECT
    from ..core.lsh import lsh_params_from_numpy
    from ..launch.mesh import (init_distributed, local_lsh, local_tensor,
                               make_host_mesh)
    torch.set_num_threads(1)
    dev = init_distributed(device, init_method=f"file://{store_dir}/store",
                           rank=rank, world_size=world_size, backend=backend,
                           timeout_s=timeout_s)
    mesh = make_host_mesh(model_parallel, device=dev)
    if "w" in inputs:
        lsh = local_lsh(mesh, lsh_params_from_numpy(
            inputs["w"], inputs["z"], inputs["r1"], inputs["r2"], "cpu"))
        x, y, xq = (local_tensor(mesh, inputs[k]) for k in ("x", "y", "xq"))
    out = {"data_rank": mesh.data_rank, "model_rank": mesh.model_rank}
    for name, spec in jobs:
        if spec["mode"] == "lm":
            out[name] = _lm_job(mesh, spec)
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
