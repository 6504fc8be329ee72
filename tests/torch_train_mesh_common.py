"""Helpers shared by the grid train-step tests (``test_torch_train_mesh.py``,
the dense archs, and ``test_torch_train_mesh_slots.py``, the other slots):
the batches, the one-process references (the port's gradient, its float32
or bf16 floor, one AdamW step, and JAX's loss and gradient), the spawn of a
grid's ``train`` job, and the checks every rank's blocks are held to."""
import threading

import numpy as np
import torch

from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import specs
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding import local_block
from repro_torch.testing.multirank import spawn_ranks
from test_torch_train import _assert_step_params, _conditioning
from repro.sharding import spec_for as jax_spec_for
from torch_lm_mesh_common import FakeMesh, _jax_block, fake_mesh, jax_blocks

GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4))    # (data, model)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
B, S = 4, 16
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def lm_batch(cfg, seed, s=S, source=None) -> dict:
    """A global numpy batch of B rows: tokens (B, s) and their next tokens
    as labels, -1 on the last column and at two more places; ``source``
    ({'frames'} or {'patches'}, B rows) added as given."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, s + 1))
    labels = tok[:, 1:].copy()
    labels[:, -1] = -1
    labels[0, 2] = labels[-1, s // 2] = -1
    return {"tokens": tok[:, :-1].astype(np.int64),
            "labels": labels.astype(np.int64), **(source or {})}


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch) -> dict:
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in batch.items()}


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _jax_grads(cfg, params, batch):
    """JAX's float32 loss and gradient of ``loss_fn``, jitted (a third
    faster than op by op at the smoke configs): (loss, numpy tree)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    step = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b, dtype=jnp.float32), has_aux=True))
    (_, m), g = step(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, _jax_batch(batch)))
    return float(m["loss"]), jax.tree.map(np.asarray, g)


def reference(cfg, params, batch, dtype="f32", jax_too=True) -> dict:
    """The one-process port on the whole batch: its loss, aux and gradient
    (numpy), each leaf's floor in ``dtype`` (``_conditioning``), one AdamW
    step from a fresh state on that gradient (``make_train_step``'s
    update); with ``jax_too``, JAX's float32 loss and gradient."""
    tdt = DTYPES[dtype]
    tp = lm_params_from_reference(params, "cpu")
    tb = _torch_batch(batch)
    m, g = TS.make_grad_step(cfg, tdt)(tp, tb)
    floor = _conditioning(cfg, params, tb, g, tdt)
    p1, o1, m1 = adamw_update(AdamWConfig(**OPT), g, adamw_init(tp), tp)
    ref = dict(loss=float(m["loss"]), aux=float(m["aux_loss"]), grads=_np(g),
               floor=floor, step=dict(
                   metrics={k: float(v) for k, v in (m | m1).items()},
                   params=_np(p1), m=_np(o1.m), v=_np(o1.v)))
    if jax_too:
        ref["jax_loss"], ref["jax_grads"] = _jax_grads(cfg, params, batch)
    return ref


def train_case(name, cfg, params, batch, dtype="f32", **extra) -> dict:
    """A case of the ``train`` job."""
    return dict(name=name, cfg=cfg, params=params, batch=batch, dtype=dtype,
                opt=OPT, **extra)


def spawn(runs: dict, tmp) -> dict:
    """One spawn running every grid of ``runs`` ({(data, model): its
    cases}) in turn, each on the first data x model ranks
    (``testing.multirank``'s ``train_grids`` job): {grid: (grid, the
    ranks' results in rank order, each with its data and model rank)}."""
    world = max(d * m for d, m in runs)
    res = spawn_ranks(world, 1, str(tmp), {},
                      [("train", dict(mode="train_grids", grids=runs))])
    return {g: (g, [r["train"][g] for r in res[:g[0] * g[1]]])
            for g in runs}


def spawn_while(runs: dict, tmp, work):
    """``spawn(runs, tmp)`` in a thread while ``work()`` runs here (the
    ranks wait on each other's collectives as often as they compute):
    (work's result, spawn's)."""
    box = {}

    def target():
        try:
            box["grids"] = spawn(runs, tmp)
        except BaseException as e:      # re-raised here, after the join
            box["error"] = e
    thread = threading.Thread(target=target)
    thread.start()
    try:
        out = work()
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return out, box["grids"]


def each_rank_case(grid, names=None):
    """(case name, rank result, that rank's case) for every rank and case
    (of ``names`` only, where given); the case's train step record
    ('step': its gradient, metrics, saved shapes, collectives, new blocks)
    also read at the case's top level."""
    for r in grid[1]:
        for name, c in r["cases"].items():
            if names is None or name in names:
                yield name, r, c["step"] | c


def blocks(tree, cfg, grid, r):
    """{path: this rank's block} of a whole numpy tree, by the port's
    ``param_shardings`` on the grid."""
    (d, m) = grid
    mesh = fake_mesh(d, m, r["data_rank"], r["model_rank"])
    spec = dict(tree_leaves(specs.param_shardings(cfg, mesh)))
    return {p: np.asarray(local_block(a, spec[p], mesh))
            for p, a in tree_leaves(tree)}


def jax_leaf_blocks(cfg, tree, grid, r):
    """{path: this rank's block} of a whole tree by the JAX package's
    param axes and ``spec_for``."""
    d, m = grid
    cut = jax_blocks(cfg, tree, {"data": d, "model": m},
                     {"data": r["data_rank"], "model": r["model_rank"]})
    return dict(tree_leaves(cut))


def grad_ratios(got, want, whole, floor, exact=False) -> dict:
    """{path: max|got - want| / max|whole leaf| over its limit} (``got`` a
    tree or {path: block}, ``want`` and ``whole`` {path: array}): 1e-6 with
    ``exact`` (the 1x1 grid), else 1e-4 or 4x the leaf's float32 floor
    where that is larger (``tests/test_torch_train.py``)."""
    out = {}
    flat = all(k.startswith("['") for k in got)
    for path, g in got.items() if flat else tree_leaves(got):
        top = float(np.abs(whole[path]).max()) + 1e-30
        err = float(np.abs(np.asarray(g, np.float64) - want[path]).max())
        limit = 1e-6 if exact else max(1e-4, 4 * floor[path])
        out[path] = err / top / limit
    return out


def worst(ratios: dict):
    path = max(ratios, key=ratios.get)
    return ratios[path], path


def check_grads_against_port(grid, references, cases):
    for name, r, c in each_rank_case(grid):
        ref, cfg = references[name], cases[name]["cfg"]
        if cases[name]["dtype"] != "f32":
            continue
        whole = dict(tree_leaves(ref["grads"]))
        ratios = grad_ratios(c["grads"], blocks(ref["grads"], cfg, grid[0], r),
                             whole, ref["floor"], exact=grid[0] == (1, 1))
        assert worst(ratios)[0] <= 1.0, (name, r["data_rank"],
                                         r["model_rank"], worst(ratios))


def check_grads_against_jax(grid, references, cases):
    for name, r, c in each_rank_case(grid):
        ref, cfg = references[name], cases[name]["cfg"]
        if "jax_grads" not in ref:
            continue
        whole = dict(tree_leaves(ref["jax_grads"]))
        ratios = grad_ratios(c["grads"], jax_leaf_blocks(
            cfg, ref["jax_grads"], grid[0], r), whole, ref["floor"])
        assert worst(ratios)[0] <= 1.0, (name, r["data_rank"],
                                         r["model_rank"], worst(ratios))


def check_loss(grid, references):
    """Loss and aux within 1e-5 relative of the one-process port's and
    JAX's (the JAX loss where the reference has one), the same on every
    rank, and ``model.loss_fn(mesh=)``'s without autograd (no remat, the
    untracked collectives) within 1e-6 of the step's."""
    seen = {}
    for name, r, c in each_rank_case(grid):
        ref = references[name]
        got = c["metrics"]
        tol = 1e-5 if "bf16" not in name else 5e-3
        assert abs(got["loss"] - ref["loss"]) <= tol * abs(ref["loss"]), name
        if "jax_loss" in ref:
            assert abs(got["loss"] - ref["jax_loss"]) <= \
                1e-5 * abs(ref["jax_loss"]), name
        assert abs(got["aux_loss"] - ref["aux"]) <= \
            1e-5 * max(abs(ref["aux"]), 1e-30), name
        for key in ("loss", "aux_loss"):        # model.loss_fn(mesh=)
            assert abs(c["eval"][key] - got[key]) <= \
                1e-6 * max(abs(got[key]), 1e-30), (name, key)
        if name in seen:
            assert got == seen[name], name
        seen[name] = got


def assemble(grid, cfg, name):
    """The whole gradient of a case's train step from the ranks' blocks:
    each rank's block written where ``param_shardings`` puts it."""
    (d, m), ranks = grid
    whole = None
    for r in ranks:
        mesh = fake_mesh(d, m, r["data_rank"], r["model_rank"])
        spec = dict(tree_leaves(specs.param_shardings(cfg, mesh)))
        got = dict(tree_leaves(r["cases"][name]["step"]["grads"]))
        if whole is None:
            shapes = dict(tree_leaves(TM.abstract_params(cfg)))
            whole = {p: np.zeros(tuple(shapes[p].shape), np.float32)
                     for p in got}
        for p, block in got.items():
            local_block(whole[p], spec[p], mesh)[...] = block
    return whole


def _unflat(flat: dict, like, path=""):
    """A nested dict of ``like``'s structure from {tree_leaves path:
    array}."""
    if isinstance(like, dict):
        return {k: _unflat(flat, like[k], f"{path}['{k}']") for k in like}
    return flat[path]


def check_step(grid, references, cases):
    """After one AdamW step from a fresh state: grad_norm and lr within
    1e-6 relative of the one-process step's and the same on every rank;
    each rank's parameter blocks by ``_assert_step_params``' rule against
    the one-process step's; its m and v blocks within 1e-6 of the leaf's
    max of the one-process ``adamw_update`` applied to the grid's own
    gradient (its blocks assembled): the update on blocks is the update of
    the whole, whatever the gradient's rounding."""
    seen = {}
    for name in grid[1][0]["cases"]:
        if cases[name]["dtype"] != "f32":
            continue
        ref, cfg = references[name], cases[name]["cfg"]
        want = ref["step"]
        tp = lm_params_from_reference(cases[name]["params"], "cpu")
        g = _unflat({p: torch.from_numpy(a) for p, a in
                     assemble(grid, cfg, name).items()}, tp)
        _, own, own_m = adamw_update(AdamWConfig(**OPT), g, adamw_init(tp),
                                     tp)
        for _, r, c in each_rank_case(grid, (name,)):
            got = c["step"]
            for key in ("grad_norm", "lr"):
                assert abs(got["metrics"][key] - want["metrics"][key]) <= \
                    1e-6 * abs(want["metrics"][key]), (name, key)
                assert abs(got["metrics"][key] - float(own_m[key])) <= \
                    1e-6 * abs(float(own_m[key])), (name, key)
            assert got["metrics"] == seen.setdefault(name, got["metrics"])
            cut = lambda t: blocks(t, cfg, grid[0], r)
            _assert_step_params(cut(want["params"]), dict(tree_leaves(
                got["params"])), cut(ref["grads"]),
                cut(cases[name]["params"]), want["metrics"]["lr"],
                AdamWConfig(**OPT).weight_decay)
            for key in ("m", "v"):
                whole = _np(getattr(own, key))
                top = {p: float(np.abs(a).max()) + 1e-30
                       for p, a in tree_leaves(whole)}
                mine = cut(whole)
                ratios = {p: float(np.abs(a - mine[p]).max()) / top[p]
                          for p, a in tree_leaves(got[key])}
                assert worst(ratios)[0] <= 1e-6, (name, key, worst(ratios))
            assert got["count"] == 1


def check_microbatches(grid, references, cases, name):
    """``name`` in 2 microbatches on ``grid``: gradient, loss and aux and
    the step equal the 1-microbatch step's within the float32 limits;
    microbatch i's rows on each data rank are the JAX split's (the global
    batch reshaped to (2, B/2), then its rows cut over 'data')."""
    (d, m), _ = grid
    ref, cfg = references[name], cases[name]["cfg"]
    tokens = cases[name]["batch"]["tokens"]
    micro = tokens.reshape((2, -1) + tokens.shape[1:])
    sizes = {"data": d, "model": m}
    whole = dict(tree_leaves(ref["grads"]))
    for _, r, c in each_rank_case(grid, (name,)):
        mc = c["micro"][2]
        ratios = grad_ratios(mc["grads"], blocks(ref["grads"], cfg, grid[0],
                                                 r), whole, ref["floor"])
        assert worst(ratios)[0] <= 1.0, worst(ratios)
        for key in ("loss", "aux_loss", "grad_norm", "lr"):
            assert abs(mc["metrics"][key] - c["metrics"][key]) <= \
                1e-5 * max(abs(c["metrics"][key]), 1e-30), key
        assert len(mc["tokens"]) == 2
        for i, seen in enumerate(mc["tokens"]):
            spec = jax_spec_for(("batch", None), micro[i].shape,
                                FakeMesh(sizes))
            np.testing.assert_array_equal(seen, _jax_block(
                micro[i], spec, sizes, {"data": r["data_rank"],
                                        "model": r["model_rank"]}))
    # the 2-microbatch step's own blocks, as the whole batch's are held
    check_step((grid[0], [r | {"cases": {name: {"step": c["micro"][2]}}}
                          for _, r, c in each_rank_case(grid, (name,))]),
               references, {name: cases[name]})


def seq_block_check(grid, cases):
    """Every group checkpoint's saved carry: (B_local, S/M, D) where the
    sequence divides 'model' (M > 1), (B_local, S, D) where it does not;
    none saves the whole carry where it divides.  Period > 4 configs
    checkpoint slots instead."""
    (d, m), _ = grid
    checked = 0
    for name, r, c in each_rank_case(grid):
        cfg = cases[name]["cfg"]
        b, s = cases[name]["batch"]["tokens"].shape
        groups = [shapes for fn, shapes in c["saved"] if fn == "group_fn"]
        if cfg.period > 4:
            assert not groups, name
            continue
        assert len(groups) == cfg.n_groups, (name, c["saved"])
        rows = b // d if b % d == 0 else b
        block = (rows, s // m, cfg.d_model)
        whole = (rows, s, cfg.d_model)
        for shapes in groups:
            carries = [t for t in shapes if len(t) == 3]
            if m > 1 and s % m == 0:
                assert carries == [block], (name, shapes)
            else:
                assert carries == [whole], (name, shapes)
        checked += 1
    return checked


def witness_rejected(grid, references, cases, name):
    """The gradient check rejects, on every rank, each replicated leaf's
    gradient M times too large (the 1/M left out of the rank's share of
    the loss: a leaf not named on 'model' is summed over M copies of the
    whole) and the gradient without its sum over 'data' (the leaves not
    named on 'data').  Returns the leaves each witness moved past the
    limit, by rank."""
    (d, m), _ = grid
    cfg = cases[name]["cfg"]
    ref = references[name]
    whole = dict(tree_leaves(ref["grads"]))
    out = []
    for nm, r, c in each_rank_case(grid, (name,)):
        mesh = fake_mesh(d, m, r["data_rank"], r["model_rank"])
        spec = dict(tree_leaves(specs.param_shardings(cfg, mesh)))
        want = blocks(ref["grads"], cfg, grid[0], r)
        names = lambda p: {e for e in spec[p] if e is not None}
        times = {p: g * m if "model" not in names(p) else g
                 for p, g in tree_leaves(c["grads"])}
        no_sum = dict(tree_leaves(c["grads_without_data_sum"]))
        rt = grad_ratios(times, want, whole, ref["floor"])
        rn = grad_ratios(no_sum, want, whole, ref["floor"])
        assert worst(grad_ratios(c["grads"], want, whole,
                                 ref["floor"]))[0] <= 1.0
        assert worst(rt)[0] > 1.0 and worst(rn)[0] > 1.0
        out.append((sum(v > 1 for v in rt.values()),
                    sum(v > 1 for v in rn.values())))
    return out

