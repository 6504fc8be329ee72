"""The train step of the dense LMs on (data, model) grids of gloo ranks
(``launch.steps.make_train_step(mesh=)``, ``models.sharded.loss_fn``)
against the one-process port and the JAX package on the same numpy
parameters and global batch.

One spawn of four ranks runs the grids 1x1, 1x2, 2x1, 2x2 and 1x4 in turn,
each on the first ranks (``testing.multirank``'s ``train_grids`` job), and
each grid every case: the smoke configs of the four dense archs in
float32, parameters at std 1/sqrt(fan-in), a batch of 4 x 16 with masked
labels.  gemma3-1b's case also restores a one-process train state
(``init_train_state``'s draws, checkpointed) by ``param_shardings`` and
``opt_shardings``.  The 2x2 grid adds gemma3-1b in bf16 compute, qwen3-14b
in 2 microbatches and the witnesses; the 1x4 grid adds qwen3-14b at a
sequence of 18 (18 % 4 != 0: the carry stays whole).  gemma3-1b's pattern
(period 6) is checkpointed slot by slot, the others group by group.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import registry
from repro_torch.launch import specs
from repro_torch.launch.steps import init_train_state
from repro_torch.models.params import tree_leaves
from torch_lm_mesh_common import np_params
from torch_train_mesh_common import (GRIDS, blocks, check_grads_against_jax,
                                     check_grads_against_port, check_loss,
                                     check_microbatches, check_step,
                                     each_rank_case, grad_ratios,
                                     lm_batch, reference, seq_block_check,
                                     spawn_while, train_case,
                                     witness_rejected, worst)

DENSE = ("gemma3-1b", "phi3-mini-3.8b", "qwen3-14b", "command-r-plus-104b")
BF16 = "gemma3-1b bf16"
SHORT = "qwen3-14b S=18"
STATE_SEED = 5


@pytest.fixture(scope="module")
def cases():
    """{case name: the job's case}: the four archs in float32, and the
    extra cases of the 2x2 (bf16) and 1x4 (S = 18) grids."""
    out = {}
    for i, arch in enumerate(DENSE):
        cfg = registry.smoke_config(arch)
        out[arch] = train_case(arch, cfg,
                               np_params(cfg, np.random.default_rng(10 + i)),
                               lm_batch(cfg, 100 + i))
    g = out["gemma3-1b"]
    out[BF16] = train_case(BF16, g["cfg"], g["params"], g["batch"], "bf16")
    q = out["qwen3-14b"]
    out[SHORT] = train_case(SHORT, q["cfg"], q["params"],
                            lm_batch(q["cfg"], 200, s=18))
    return out


@pytest.fixture(scope="module")
def state(cases, tmp_path_factory):
    """A one-process train state of gemma3-1b's smoke config, drawn by
    ``init_train_state`` from STATE_SEED and checkpointed."""
    path = tmp_path_factory.mktemp("train_state")
    params, opt = init_train_state(cases["gemma3-1b"]["cfg"],
                                   torch.Generator().manual_seed(STATE_SEED))
    save_checkpoint(str(path), 0, {"params": params, "opt": opt})
    return str(path)


def _run(shape, cases, state):
    """The cases one grid runs: the four archs (gemma3-1b's with the
    train state to restore); on 2x2 also the bf16 case, qwen3-14b in 2
    microbatches and gemma3-1b's witnesses; on 1x4 the S = 18 case."""
    run = [dict(c, state=state, seed=STATE_SEED) if name == "gemma3-1b"
           else c for name, c in cases.items() if name in DENSE]
    if shape == (2, 2):
        run = [dict(c, microbatches=(2,)) if c["name"] == "qwen3-14b" else
               dict(c, witness=True) if c["name"] == "gemma3-1b" else c
               for c in run] + [cases[BF16]]
    if shape == (1, 4):
        run.append(cases[SHORT])
    return run


@pytest.fixture(scope="module")
def runs(cases, state, tmp_path_factory):
    """(the references by case, {(d, m): ((d, m), the ranks' results)}):
    one spawn running every grid's cases in turn, while the one-process
    port's and JAX's references are computed here."""
    def refs():
        return {name: reference(c["cfg"], c["params"], c["batch"],
                                c["dtype"], jax_too=c["dtype"] == "f32"
                                and name != SHORT)
                for name, c in cases.items()}
    return spawn_while({g: _run(g, cases, state) for g in GRIDS},
                       tmp_path_factory.mktemp("train_grids"), refs)


@pytest.fixture(scope="module")
def references(runs):
    return runs[0]


@pytest.fixture(scope="module")
def grids(runs):
    return runs[1]


@pytest.fixture(params=GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def grid(request, grids):
    return grids[request.param]


def test_loss_is_global_and_matches(grid, references):
    """Each rank's loss and aux within 1e-5 relative of the one-process
    port's and JAX's on the whole batch (bf16: 5e-3 of the port's bf16),
    the same on every rank; the step reports the same loss."""
    check_loss(grid, references)


def test_grads_match_the_one_process_port(grid, references, cases):
    """Every rank's gradient blocks against the one-process port's
    gradient cut by ``local_block``: within 1e-4 of the leaf's max|g| or 4x
    its float32 floor; on the 1x1 grid within 1e-6 (one-rank groups: every
    sum is the identity) and bit for bit."""
    check_grads_against_port(grid, references, cases)
    if grid[0] == (1, 1):
        for name, _, c in each_rank_case(grid, DENSE):
            for (path, a), (_, b) in zip(
                    tree_leaves(c["grads"]),
                    tree_leaves(references[name]["grads"])):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {path}")


def test_grads_match_jax(grid, references, cases):
    """Every rank's gradient blocks against ``jax.grad``'s, cut by the JAX
    package's ``spec_for``, within 1e-4 of the leaf's max|g| or 4x its
    float32 floor."""
    check_grads_against_jax(grid, references, cases)


def test_adamw_step_matches(grid, references, cases):
    """One step from a fresh AdamW state: each rank's parameter, m and v
    blocks are the one-process update's (parameters by the |g| > 1e-5
    rule, m and v within 1e-6 of max), grad_norm and lr within 1e-6
    relative and the same on every rank."""
    check_step(grid, references, cases)


def test_collectives_are_the_same_on_every_rank(grid):
    """Every rank runs the same collectives in a step, forward and
    backward (calls and bytes by kind); all-gathers and their adjoint
    reduce-scatters where a leaf is gathered at use (any grid past 1x1);
    the one-rank groups' all-reduces run on the 1x1 grid too."""
    (d, m), ranks = grid
    for name in ranks[0]["cases"]:
        counts = [r["cases"][name]["step"]["collectives"] for r in ranks]
        assert all(c == counts[0] for c in counts), name
        assert counts[0]["all_reduce"]["calls"] > 0, name
        assert ("reduce_scatter" in counts[0]) == \
            ("all_gather" in counts[0]) == (d > 1 or m > 1), \
            (name, counts[0])


def test_group_checkpoints_keep_the_sequence_block(grid, cases):
    """What each group checkpoint saves for the backward (through
    ``saved_tensors_hooks``): the rank's (B_local, S/M, D) block of the
    carry where S divides by M > 1, the whole (B_local, S, D) where it does
    not (qwen3-14b at S = 18 on 1x4) or M = 1."""
    assert seq_block_check(grid, cases) > 0


def test_train_state_restores_to_each_ranks_blocks(grid):
    """gemma3-1b's one-process train state, checkpointed, restored by
    ``restore_resharded`` with ``param_shardings`` and ``opt_shardings``:
    exactly the blocks of ``init_train_state(mesh=)`` (the same draws),
    one step from either is the same, and the parameter, m, v and step
    bytes a rank holds are ``shard_bytes``' params + opt_state."""
    for _, _, c in each_rank_case(grid, ("gemma3-1b",)):
        st = c["state"]
        assert st["restored_equal"] and st["steps_equal"]
        assert st["held"] == st["shard_bytes"]["params"] + \
            st["shard_bytes"]["opt_state"]


def test_bf16_grads_within_their_floor(grids, references, cases):
    """2x2, gemma3-1b in bf16 compute: the FSDP gathers and the
    row-parallel sums run in bf16, so the gather's reduce-scatter sums
    bf16 partial gradients, one rounding more than in one process.  Each
    gradient leaf within 2x its bf16 floor (``_conditioning``) of the
    one-process port's bf16 gradient; the loss within 5e-3 relative."""
    grid = grids[2, 2]
    ref, cfg = references[BF16], cases[BF16]["cfg"]
    whole = dict(tree_leaves(ref["grads"]))
    for _, r, c in each_rank_case(grid, (BF16,)):
        want = blocks(ref["grads"], cfg, grid[0], r)
        ratios = {p: v * max(1e-4, 4 * ref["floor"][p]) /
                  (2 * ref["floor"][p]) for p, v in grad_ratios(
                      c["grads"], want, whole, ref["floor"]).items()}
        assert worst(ratios)[0] <= 1.0, worst(ratios)
        assert abs(c["metrics"]["loss"] - ref["loss"]) <= \
            5e-3 * abs(ref["loss"])


def test_microbatches_match_the_whole_batch(grids, references, cases):
    """2x2, qwen3-14b in 2 microbatches: gradient, loss and the step equal
    the 1-microbatch step's within the float32 limits; microbatch i's rows
    on each data rank are the JAX split's (the global batch reshaped to
    (2, B/2), then its rows cut over 'data')."""
    check_microbatches(grids[2, 2], references, cases, "qwen3-14b")


def test_the_check_rejects_the_two_likely_mistakes(grids, references,
                                                   cases):
    """2x2, gemma3-1b: the gradient check that passes the grid's gradient
    rejects, on every rank, the gradient of each leaf not named on 'model'
    M times too large (the 1/M left out of the rank's share) and the
    gradient without its sum over 'data' (the leaves not named on
    'data')."""
    got = witness_rejected(grids[2, 2], references, cases, "gemma3-1b")
    assert len(got) == 4 and all(a > 0 and b > 0 for a, b in got), got


def test_opt_shardings_and_microbatch_counts():
    """``opt_shardings``: m and v laid out as the parameters, the step
    replicated; ``TRAIN_MICROBATCHES`` is the JAX dry run's (read from its
    source: importing ``repro.launch.dryrun`` sets the process's XLA device
    count)."""
    import ast
    from pathlib import Path

    import repro
    src = Path(repro.__file__).parent / "launch" / "dryrun.py"
    want = next(ast.literal_eval(node.value)
                for node in ast.parse(src.read_text()).body
                if isinstance(node, ast.AnnAssign)
                and node.target.id == "TRAIN_MICROBATCHES")
    assert specs.TRAIN_MICROBATCHES == want
    cfg = registry.smoke_config("qwen3-14b")
    for mesh in ({"data": 2, "model": 2}, {"pod": 2, "data": 16,
                                            "model": 16}):
        opt = specs.opt_shardings(cfg, mesh)
        p = specs.param_shardings(cfg, mesh)
        assert opt.step == () and opt.m == p and opt.v == p
