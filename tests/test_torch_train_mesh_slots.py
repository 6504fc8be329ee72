"""The train step of the other LM slots on (data, model) grids of gloo
ranks (``launch.steps.make_train_step(mesh=)``): expert-parallel MoE
(its aux loss averaged over 'data'), mamba2 on ``ssm_heads`` (the gathered
``in_proj`` output, the causal conv computed whole), rwkv6 on ``heads``
(the channel mix's gate computed whole), zamba2's shared attention, the
VLM's cross attention and whisper's encoder (each layer rematerialized with
its weights gathered inside), against the one-process port and the JAX
package on the same numpy parameters and global batch.

One spawn of four ranks runs the grids 1x1, 2x2 and 1x4 in turn
(``testing.multirank``'s ``train_grids`` job), each grid every case: the
smoke configs of zamba2-7b, rwkv6-1.6b, mixtral-8x22b,
llama4-scout-17b-a16e, whisper-large-v3 and llama-3.2-vision-90b in
float32, a batch of 4 x 16 with masked labels (whisper's frames and the
VLM's patches drawn for the same 4 rows).  Parameters as
``tests/test_torch_lm_mesh_slots.py`` draws them (std 1/sqrt(fan-in), the
decays, bonus and token-shift mixes non-zero) and the MoE configs at
capacity factor 0.5, so the dispatch drops pairs.  The 2x2 grid also runs
mixtral-8x22b in 2 microbatches.  At 1x4 every expert, ssm head and query
head is one rank's; llama-3.2-vision's period 5 is checkpointed slot by
slot, the others group by group.  The 1x2 and 2x1 grids are left out
here to keep the file under 150 s on one worker of a 6-worker
``pytest -n 6`` run (189 s with them); ``tests/test_torch_train_mesh.py``
runs the dense archs on all five grids.
"""
import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.models.params import tree_leaves
from test_torch_lm_mesh_slots import _low_capacity, _np_params, _source
from torch_train_mesh_common import (check_grads_against_jax,
                                     check_grads_against_port, check_loss,
                                     check_microbatches, check_step,
                                     each_rank_case, lm_batch, reference,
                                     seq_block_check, spawn_while,
                                     train_case)

GRIDS = ((1, 1), (2, 2), (1, 4))    # (data, model)
ARCHS = ("zamba2-7b", "rwkv6-1.6b", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "whisper-large-v3", "llama-3.2-vision-90b")
MICRO = "mixtral-8x22b"


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = _low_capacity(registry.smoke_config(arch))
        out[arch] = train_case(arch, cfg, _np_params(cfg, 40 + i),
                               lm_batch(cfg, 400 + i,
                                        source=_source(cfg, 500 + i)))
    return out


def _run(shape, cases):
    return [dict(c, microbatches=(2,)) if shape == (2, 2) and name == MICRO
            else c for name, c in cases.items()]


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """(the references by case, {(d, m): ((d, m), the ranks' results)}):
    one spawn running every grid's cases in turn, while the one-process
    port's and JAX's references are computed here."""
    def refs():
        return {name: reference(c["cfg"], c["params"], c["batch"])
                for name, c in cases.items()}
    return spawn_while({g: _run(g, cases) for g in GRIDS},
                       tmp_path_factory.mktemp("train_slot_grids"), refs)


@pytest.fixture(scope="module")
def references(runs):
    return runs[0]


@pytest.fixture(params=GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def grid(request, runs):
    return runs[1][request.param]


def test_loss_and_aux_are_global_and_match(grid, references):
    """Each rank's loss and the MoE aux (the mean over 'data' of its rows'
    aux) within 1e-5 relative of the one-process port's and JAX's loss on
    the whole batch, the same on every rank."""
    check_loss(grid, references)


def test_grads_match_the_one_process_port(grid, references, cases):
    """Every rank's gradient blocks (router, experts, mamba2's conv and
    in_proj, rwkv6's heads and gate, the shared block, the encoder)
    against the one-process port's gradient cut by ``local_block``: within
    1e-4 of the leaf's max|g| or 4x its float32 floor; on the 1x1 grid
    within 1e-6 and bit for bit."""
    check_grads_against_port(grid, references, cases)
    if grid[0] == (1, 1):
        for name, _, c in each_rank_case(grid):
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
    blocks are the one-process update's, grad_norm and lr within 1e-6
    relative and the same on every rank."""
    check_step(grid, references, cases)


def test_collectives_are_the_same_on_every_rank(grid):
    """Every rank runs the same collectives in a step, forward and
    backward: a model rank whose experts got no pairs runs the others'
    all-reduces; the backward's reduce-scatters match the all-gathers."""
    (d, m), ranks = grid
    for name in ranks[0]["cases"]:
        counts = [r["cases"][name]["step"]["collectives"] for r in ranks]
        assert all(c == counts[0] for c in counts), name
        assert ("reduce_scatter" in counts[0]) == ("all_gather" in counts[0])


def test_group_checkpoints_keep_the_sequence_block(grid, cases):
    """The saved carry of every group checkpoint is the rank's (B_local,
    S/M, D) block where 16 divides by M > 1, whole at M = 1."""
    assert seq_block_check(grid, cases) > 0


def test_moe_microbatches_match_the_whole_batch(runs, references, cases):
    """2x2, mixtral-8x22b in 2 microbatches: the gradient (the aux of each
    microbatch averaged), loss and aux and the step equal the whole
    batch's within the float32 limits, each microbatch's rows the JAX
    split's on every data rank."""
    check_microbatches(runs[1][2, 2], references, cases, MICRO)
