"""The dense LMs served on (data, model) grids of gloo ranks
(``repro_torch.models.sharded``), against the one-process port and the JAX
package on the same numpy parameters.

One spawn a grid (1x1, 1x2, 2x1, 2x2, 1x4, 1x3; ``testing.multirank``'s
``lm`` job) runs every case in it: the smoke configs of the four dense
archs and qwen3's with 6 heads (at model 4 its heads do not divide, so
``wq`` falls back to ``head_dim``, qwen3-14b's case at model 16), at batch
4 and, where the data axis is 2, at batch 3 (the rows are not split and the
caches' seq dim takes the data axis).  The 1x4 grid puts the smoke configs'
2 kv heads on ``head_dim`` (each rank reads kv head r // 2); at 1x3 only
``d_ff`` and the global layers' 12-row caches divide.  Weights are drawn
at std 1/sqrt(fan-in) (``testing.train.fan_in_scale``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import registry as jax_registry
from repro.models import model as JM
from repro_torch.configs import ShapeSpec, registry
from repro_torch.convert import lm_params_from_reference, local_lm_params
from repro_torch.launch import specs
from repro_torch.launch.serve import generate
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves
from repro_torch.sharding import local_shape
from repro_torch.testing.multirank import spawn_ranks
from torch_lm_mesh_common import (batches, case_name, each_case, fake_mesh,
                                  jax_blocks, np_params, rel)

GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (1, 3))   # (data, model)
DENSE = ("gemma3-1b", "phi3-mini-3.8b", "qwen3-14b", "command-r-plus-104b")
HEADS6 = "qwen3-14b/6 heads"
S, N, CACHE = 9, 3, 12          # prompt, decode steps, cache rows
GEN = 2                         # generate(mesh=)'s tokens
CLI_ARGS = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--batch",
            "3", "--prompt-len", "9", "--gen", "3", "--seed", "5"]


def _configs():
    """(name, port config, JAX config) of every case."""
    out = [(a, registry.smoke_config(a), jax_registry.smoke_config(a))
           for a in DENSE]
    six = dict(name=HEADS6, n_heads=6)
    out.append((HEADS6,
                dataclasses.replace(registry.smoke_config("qwen3-14b"), **six),
                dataclasses.replace(jax_registry.smoke_config("qwen3-14b"),
                                    **six)))
    return out


@pytest.fixture(scope="module")
def cases():
    """{case name: dict(cfg, jcfg, params, tokens, steps)} for batches 4
    and 3."""
    out = {}
    for i, (name, cfg, jcfg) in enumerate(_configs()):
        params = np_params(cfg, np.random.default_rng(10 + i))
        toks = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, (4, S + N)).astype(np.int64)
        for b in (4, 3):         # batch 3: the first three rows
            out[case_name(name, b)] = dict(
                cfg=cfg, jcfg=jcfg, params=params, tokens=toks[:b, :S],
                steps=toks[:b, S:])
    return out


@pytest.fixture(scope="module")
def references(cases):
    """Per case: the one-process port's and the JAX package's prefill and
    decode logits ([prefill, step 1, ...], numpy), and the one-process
    port's greedy ids over GEN tokens; batch 3's are batch 4's first
    rows (each row's are its own)."""
    out = {}
    for key, c in cases.items():
        if key.endswith("B=3"):
            continue
        cfg, tp = c["cfg"], lm_params_from_reference(c["params"], "cpu")
        jp = jax.tree.map(jnp.asarray, c["params"])
        tok, steps = c["tokens"], c["steps"]
        with torch.inference_mode():
            hidden = TM.forward(cfg, tp, {"tokens": torch.from_numpy(tok)},
                                dtype=torch.float32)[0].numpy()
            lg, cache, pos = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(
                tok)}, max_cache_len=CACHE, dtype=torch.float32)
            port = [lg.numpy()]
            for t in range(N):
                lg, cache = TM.decode_step(
                    cfg, tp, cache, torch.from_numpy(steps[:, t:t + 1]), pos,
                    dtype=torch.float32)
                pos = pos + 1
                port.append(lg.numpy())
            ids = generate(cfg, tp, torch.from_numpy(tok), GEN,
                           generator=torch.Generator())[0].numpy()
        pre = jax.jit(functools.partial(JM.prefill, c["jcfg"],
                                        max_cache_len=CACHE,
                                        dtype=jnp.float32))
        dec = jax.jit(functools.partial(JM.decode_step, c["jcfg"],
                                        dtype=jnp.float32))
        jl, jc, jpos = pre(jp, {"tokens": jnp.asarray(tok)})
        ref = [np.asarray(jl)]
        for t in range(N):
            jl, jc = dec(jp, jc, jnp.asarray(steps[:, t:t + 1]), jpos)
            jpos = jpos + 1
            ref.append(np.asarray(jl))
        out[key] = dict(port=port, jax=ref, ids=ids, hidden=hidden)
        out[key.replace("B=4", "B=3")] = dict(
            port=[a[:3] for a in port], jax=[a[:3] for a in ref],
            ids=ids[:3], hidden=hidden[:3])
    return out


def _ties(vocab: int) -> np.ndarray:
    """(4, vocab) logits with equal maxima planted in different vocab
    blocks (at model 2, 3 and 4), and a row of equal logits."""
    t = np.random.default_rng(7).standard_normal((4, vocab)).astype(
        np.float32)
    for row, cols in enumerate(((5, vocab - 1), (vocab // 2, vocab // 2 - 1),
                                (vocab // 3 + 1, vocab // 4 * 3 + 2))):
        t[row, list(cols)] = 9.0
    t[3] = 1.0
    return t


@pytest.fixture(scope="module", params=GRIDS,
                ids=[f"{d}x{m}" for d, m in GRIDS])
def grid(request, cases, tmp_path_factory):
    """One spawn of the grid running every case: (grid, rank results),
    the ranks in order.  The checkpoint written by the JAX package's store
    (gemma3-1b's parameters) is restored on every rank by
    ``param_shardings``."""
    d, m = request.param
    tmp = tmp_path_factory.mktemp(f"grid{d}x{m}")
    ckpt_case = case_name("gemma3-1b", 4)
    jax_save_checkpoint(str(tmp / "ckpt"), 1, cases[ckpt_case]["params"])
    job = dict(mode="lm", ckpts={ckpt_case: str(tmp / "ckpt")},
               ties_case=ckpt_case,
               ties=_ties(cases[ckpt_case]["cfg"].vocab_size), cases=[
                   dict(name=k, cfg=c["cfg"], params=c["params"],
                        tokens=c["tokens"], steps=c["steps"],
                        max_cache_len=CACHE, gen=GEN)
                   for k, c in cases.items()
                   if c["tokens"].shape[0] in batches((d, m))])
    cli = dict(mode="serve_cli", argv=["--mesh", f"{d}x{m}"] + CLI_ARGS)
    res = spawn_ranks(d * m, m, str(tmp), {}, [("lm", job), ("cli", cli)])
    return (d, m), [r["lm"] | {"data_rank": r["data_rank"],
                               "model_rank": r["model_rank"],
                               "cli": r["cli"]} for r in res]


def test_logits_match_the_one_process_port(grid, references):
    """Prefill and every decode step's logits, each rank's rows over the
    whole vocab, within 1e-5 of max|logit| of the one-process port on the
    same weights; bitwise on the 1x1 grid (a one-rank group's sums are
    the identity)."""
    for name, _, c in each_case(grid):
        want = references[name]["port"]
        got = [c["prefill"]] + c["decode"]
        assert len(got) == N + 1
        for g, w in zip(got, want):
            w = w[c["rows"]]
            assert g.shape == w.shape and np.isfinite(g).all()
            if grid[0] == (1, 1):
                np.testing.assert_array_equal(g, w)
            assert rel(g, w) <= 1e-5, (name, rel(g, w))


def test_forward_matches_the_one_process_port(grid, references):
    """``model.forward(mesh=)``: each rank's rows of the final hidden
    states within 1e-5 of their max (bitwise on the 1x1 grid)."""
    for name, _, c in each_case(grid):
        want = references[name]["hidden"][c["rows"]]
        if grid[0] == (1, 1):
            np.testing.assert_array_equal(c["hidden"], want)
        assert rel(c["hidden"], want) <= 1e-5, name


def test_logits_match_jax(grid, references):
    """The same logits against the JAX package's prefill/decode_step,
    within tests/test_torch_lm.py's f32 tolerance (1e-4 of max)."""
    for name, _, c in each_case(grid):
        for g, w in zip([c["prefill"]] + c["decode"],
                        references[name]["jax"]):
            assert rel(g, w[c["rows"]]) <= 1e-4, name


def test_rows_are_split_over_data_where_the_batch_divides(grid):
    (d, m), ranks = grid
    for name, r, c in each_case(grid):
        b = 3 if name.endswith("B=3") else 4
        if b % d == 0:
            step = b // d
            want = np.arange(r["data_rank"] * step, (r["data_rank"] + 1)
                             * step)
        else:
            want = np.arange(b)
        np.testing.assert_array_equal(c["rows"], want)


def test_each_rank_holds_its_shard_bytes(grid, cases):
    """Parameter bytes a rank equal ``shard_bytes``; every cache block has
    the local shape of ``cache_shardings``."""
    (d, m), _ = grid
    mesh = {"data": d, "model": m}
    for name, _, c in each_case(grid):
        cfg, b = cases[name]["cfg"], cases[name]["tokens"].shape[0]
        shape = ShapeSpec("decode", CACHE, b, "decode")
        assert c["param_bytes"] == specs.shard_bytes(cfg, shape,
                                                     mesh)["params"]
        cspec = specs.cache_shardings(cfg, shape, mesh)
        abstract = TM.abstract_cache(cfg, b, CACHE)
        for slot, leaves in c["cache_shapes"].items():
            for leaf, got in leaves.items():
                assert got == local_shape(abstract[slot][leaf].shape,
                                          cspec[slot][leaf], mesh)


def test_kv_heads_read_by_each_rank(grid, cases):
    """A rank's query heads [r H/M, (r+1) H/M) read kv heads h // (H/KV):
    its own kv heads where kv_heads is sharded (no index), else the index
    names them (one kv head, or one a query head), in every slot's
    attention."""
    (d, m), _ = grid
    for name, r, c in each_case(grid):
        cfg = cases[name]["cfg"]
        h, kv = cfg.n_heads, cfg.n_kv_heads
        assert sorted(c["kv_heads"]) == [f"slot{i}.attn" for i in
                                         range(len(cfg.layer_pattern))]
        got = set(map(str, c["kv_heads"].values()))
        assert len(got) == 1, (name, c["kv_heads"])
        if h % m or m == 1:
            assert got == {"None"}
            continue
        hl = h // m
        read = [j // (h // kv) for j in range(r["model_rank"] * hl,
                                              (r["model_rank"] + 1) * hl)]
        if kv % m == 0:
            assert got == {"None"}
            assert read == [r["model_rank"] * (kv // m) + j // (h // kv)
                            for j in range(hl)]
        else:
            want = read[:1] if len(set(read)) == 1 else read
            assert got == {str(want)}, (name, r["model_rank"])
    if (d, m) == (1, 4):
        got = [r["cases"][case_name("qwen3-14b", 4)]["kv_heads"]
               ["slot0.attn"] for r in grid[1]]
        assert got == [[0], [0], [1], [1]]


def test_collectives_of_a_step(grid, cases):
    """Collectives always run: a decode step all-reduces each sublayer's
    partial result over 'model' and the embedding lookup (2 L + 1), on a
    one-rank group too; gathers run only where a dim is gathered at use."""
    (d, m), _ = grid
    for name, _, c in each_case(grid):
        cfg = cases[name]["cfg"]
        for step in c["collectives"][1:]:
            red = step["all_reduce"]["calls"]
            if m == 1:
                assert red == 2 * cfg.n_layers + 1
                if d == 1:
                    assert "all_gather" not in step
            assert red <= 2 * cfg.n_layers + 1
        if d == 2:     # the FSDP gathers of 'embed'
            assert c["collectives"][1]["all_gather"]["calls"] > 0


def test_generate_on_the_grid(grid, references):
    """``generate(mesh=)``: global ids on every rank, each the cross-rank
    argmax of the grid's own logits at that step; on the 1x1 grid the
    one-process port's ids."""
    for name, r, c in each_case(grid):
        ids = c["generate"]
        assert ids.shape == (len(references[name]["ids"]), GEN)
        for t, lg in enumerate(c["generate_logits"]):
            np.testing.assert_array_equal(ids[c["rows"], t],
                                          lg.argmax(axis=-1))
        np.testing.assert_array_equal(
            ids, grid[1][0]["cases"][name]["generate"])
        if grid[0] == (1, 1):
            np.testing.assert_array_equal(ids, references[name]["ids"])


def test_argmax_tie_picks_the_lower_index(grid, cases):
    """Equal maxima in different vocab blocks: the lowest index, as
    torch.argmax on the gathered logits."""
    want = torch.argmax(torch.from_numpy(_ties(
        cases[case_name("gemma3-1b", 4)]["cfg"].vocab_size)), -1).numpy()
    assert list(want[:3]) == [5, cases[case_name("gemma3-1b", 4)][
        "cfg"].vocab_size // 2 - 1, cases[case_name("gemma3-1b", 4)][
        "cfg"].vocab_size // 3 + 1] and want[3] == 0
    for r in grid[1]:
        np.testing.assert_array_equal(r["ties"], want)


def test_restore_resharded_gives_each_rank_its_block(grid, cases):
    """A checkpoint written by the JAX package's store, restored on each
    rank by ``param_shardings``: exactly the block the JAX specs give that
    rank, bitwise, and ``local_lm_params``' blocks."""
    (d, m), ranks = grid
    name = case_name("gemma3-1b", 4)
    c = cases[name]
    for r in ranks:
        assert r["restored_equal"][name]
        want = jax_blocks(c["jcfg"], c["params"], {"data": d, "model": m},
                           {"data": r["data_rank"], "model": r["model_rank"]})
        got = dict(tree_leaves(r["restored"][name]))
        for path, w in tree_leaves(want):
            np.testing.assert_array_equal(got[path], w)


def test_groups_of_the_grid(grid):
    """``make_host_mesh``'s groups, as the LM step uses them: the data
    group is the ranks of my model index, the model group those of my data
    index (row-major, rank = data index x model + model index)."""
    (d, m), ranks = grid
    for rank, r in enumerate(ranks):
        assert (r["data_rank"], r["model_rank"]) == divmod(rank, m)
        data_g, model_g = r["groups"]
        assert list(data_g) == [i * m + r["model_rank"] for i in range(d)]
        assert list(model_g) == [r["data_rank"] * m + j for j in range(m)]


def test_serve_cli_on_the_grid(grid):
    """``launch.serve --mesh DxM`` on every rank of the grid: rank 0 prints
    the run and the greedy ids of the one-process ``generate`` on the same
    draws (the host generator's, leaf by leaf in sorted key order, then the
    prompt), the others print nothing."""
    (d, m), ranks = grid
    cfg = registry.smoke_config("qwen3-14b")
    gen = torch.Generator().manual_seed(5)
    params = TM.init(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (3, 9), generator=gen)
    ids = generate(cfg, params, tokens, 3, generator=gen)[0]
    assert all(r["cli"]["rc"] == 0 for r in ranks)
    out = ranks[0]["cli"]["out"].splitlines()
    assert f"({d}x{m} grid)" in out[0]
    rows = [[int(t) for t in line.split()[:-1]] for line in out[2:]]
    assert rows == ids[:2].tolist()
    assert all(r["cli"]["out"] == "" for r in ranks[1:])


@pytest.mark.parametrize("arch", DENSE)
def test_local_lm_params_on_jax_params(arch):
    """The JAX package's parameters (JAX arrays) cut into each rank's blocks
    of a 2x2 grid: the blocks the JAX specs give, bitwise, in float32."""
    cfg, jcfg = registry.smoke_config(arch), jax_registry.smoke_config(arch)
    params = np_params(cfg, np.random.default_rng(3))
    jp = jax.tree.map(jnp.asarray, params)
    for di in range(2):
        for mi in range(2):
            got = local_lm_params(jp, cfg, fake_mesh(2, 2, di, mi),
                                  device="cpu")
            want = jax_blocks(jcfg, params, {"data": 2, "model": 2},
                               {"data": di, "model": mi})
            for (p, g), (q, w) in zip(tree_leaves(got), tree_leaves(want)):
                assert p == q and g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), w)
