"""The other LM slots served on (data, model) grids of gloo ranks
(``repro_torch.models.sharded``): expert-parallel MoE, mamba2 on
``ssm_heads``, rwkv6 on ``heads``, shared and cross attention and
whisper's encoder, against the one-process port and the JAX package on the
same numpy parameters.

One spawn a grid (1x1, 1x2, 2x2, 1x3, 1x4; ``testing.multirank``'s ``lm``
job) runs every case in it: the smoke configs of zamba2-7b, rwkv6-1.6b,
mixtral-8x22b, llama4-scout-17b-a16e, whisper-large-v3 and
llama-3.2-vision-90b at batch 4 and, where the data axis is 2, at batch 3
(the rows are not split), with ``launch.serve --mesh`` for whisper and the
VLM in the same spawn.  At 1x2 the smoke configs' 4 experts are 2 a rank
and mamba2's 8 ssm heads 4; at 1x4 one expert a rank, one query head a
rank and the 2 kv heads on ``head_dim``; at 1x3 the experts fall to
``mlp``, no head count divides (zamba2 keeps only its conv channels on
``model``, whisper's self-attention cache its rows); 2x2 adds the rows and
FSDP over ``data``.  The MoE configs route at capacity factor 0.5, so the
prefill drops pairs.  Weights are drawn at std 1/sqrt(fan-in)
(``testing.train.fan_in_scale``), the mamba2 and rwkv6 decays, bonus and
token-shift mixes non-zero.
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
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import specs
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import source_inputs
from repro_torch.models import model as TM
from repro_torch.models import moe, sharded
from repro_torch.models.params import tree_leaves
from repro_torch.sharding import local_shape
from repro_torch.testing.multirank import spawn_ranks
from torch_lm_mesh_common import (batches, case_name, each_case,
                                  fake_mesh, jax_blocks, np_params, rel)

GRIDS = ((1, 1), (1, 2), (2, 2), (1, 3), (1, 4))   # (data, model)
ARCHS = ("zamba2-7b", "rwkv6-1.6b", "mixtral-8x22b", "llama4-scout-17b-a16e",
         "whisper-large-v3", "llama-3.2-vision-90b")
SOURCED = ("whisper-large-v3", "llama-3.2-vision-90b")
# leaves restored from a JAX-written checkpoint on every rank: the shared
# block and the mamba2 mixer, the expert stacks, the encoder
CKPT = ("zamba2-7b", "mixtral-8x22b", "whisper-large-v3")
S, N, CACHE = 16, 3, 24         # prompt, decode steps, cache rows
GEN = 2                         # generate(mesh=)'s tokens
CAPACITY = 0.5
CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "6",
       "--gen", "3", "--seed", "3"]


def _low_capacity(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY))


def _live_states(tree, rng):
    """In place: the decay, bonus and token-shift leaves drawn non-zero."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            _live_states(v, rng)
        elif k in ("a_log", "dt_bias", "w0", "u_bonus"):
            tree[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.startswith("mu_"):
            tree[k] = rng.uniform(0.0, 1.0, v.shape).astype(np.float32)


def _np_params(cfg, seed):
    """``np_params`` with the decay, bonus and token-shift leaves live."""
    rng = np.random.default_rng(seed)
    params = np_params(cfg, rng)
    _live_states(params, rng)
    return params


def _source(cfg, seed):
    """The global cross-attention source of 4 rows, numpy: {'frames'}
    (encoder), {'patches'} (VLM) or {}."""
    if cfg.encoder is not None:
        name, length = "frames", cfg.encoder.n_frames
    elif cfg.cross_attn_source_len:
        name, length = "patches", cfg.cross_attn_source_len
    else:
        return {}
    x = 0.1 * np.random.default_rng(seed).standard_normal(
        (4, length, cfg.d_model))
    return {name: x.astype(np.float32)}


def _dropped(maps, k) -> int:
    """(token, expert) pairs past capacity over the MoE calls whose
    dispatch maps (tok_map (B, E cap) with sentinel S, w_map) are given."""
    return sum(tok.shape[0] * S * k - int((tok < S).sum())
               for tok, _ in maps)


@pytest.fixture(scope="module")
def cases():
    """{case name: dict(cfg, jcfg, params, tokens, steps, source)} for
    batches 4 and 3 (batch 3: the first three rows)."""
    out = {}
    for i, name in enumerate(ARCHS):
        cfg = _low_capacity(registry.smoke_config(name))
        jcfg = _low_capacity(jax_registry.smoke_config(name))
        params = _np_params(cfg, 20 + i)
        toks = np.random.default_rng(200 + i).integers(
            0, cfg.vocab_size, (4, S + N)).astype(np.int64)
        src = _source(cfg, 300 + i)
        for b in (4, 3):
            out[case_name(name, b)] = dict(
                cfg=cfg, jcfg=jcfg, params=params, tokens=toks[:b, :S],
                steps=toks[:b, S:], source={k: v[:b] for k, v in src.items()})
    return out


@pytest.fixture(scope="module")
def references(cases):
    """Per case: the one-process port's and the JAX package's prefill and
    decode logits ([prefill, step 1, ...], numpy), the port's final hidden
    states, greedy ids over GEN tokens and MoE dispatch maps of the
    prefill; batch 3's are batch 4's first rows (each row's are its
    own)."""
    out = {}
    real = moe._dispatch_row
    for key, c in cases.items():
        if key.endswith("B=3"):
            continue
        cfg, tp = c["cfg"], lm_params_from_reference(c["params"], "cpu")
        jp = jax.tree.map(jnp.asarray, c["params"])
        tok, steps = c["tokens"], c["steps"]
        src = {k: torch.from_numpy(v) for k, v in c["source"].items()}
        batch = {"tokens": torch.from_numpy(tok), **src}
        maps = []

        def recording(logits, e, k, cap):
            m = real(logits, e, k, cap)
            maps.append((m[0].numpy(), m[1].numpy()))
            return m
        with torch.inference_mode():
            hidden = TM.forward(cfg, tp, batch, dtype=torch.float32)[0]
            moe._dispatch_row = recording
            try:
                lg, cache, pos = TM.prefill(cfg, tp, batch,
                                            max_cache_len=CACHE,
                                            dtype=torch.float32)
            finally:
                moe._dispatch_row = real
            port = [lg.numpy()]
            for t in range(N):
                lg, cache = TM.decode_step(
                    cfg, tp, cache, torch.from_numpy(steps[:, t:t + 1]), pos,
                    dtype=torch.float32)
                pos = pos + 1
                port.append(lg.numpy())
            ids = generate(cfg, tp, torch.from_numpy(tok), GEN,
                           generator=torch.Generator(), source=src)[0]
        pre = jax.jit(functools.partial(JM.prefill, c["jcfg"],
                                        max_cache_len=CACHE,
                                        dtype=jnp.float32))
        dec = jax.jit(functools.partial(JM.decode_step, c["jcfg"],
                                        dtype=jnp.float32))
        jl, jc, jpos = pre(jp, {"tokens": jnp.asarray(tok), **{
            k: jnp.asarray(v) for k, v in c["source"].items()}})
        ref = [np.asarray(jl)]
        for t in range(N):
            jl, jc = dec(jp, jc, jnp.asarray(steps[:, t:t + 1]), jpos)
            jpos = jpos + 1
            ref.append(np.asarray(jl))
        out[key] = dict(port=port, jax=ref, ids=ids.numpy(),
                        hidden=hidden.numpy(), dispatch=maps)
        out[key.replace("B=4", "B=3")] = dict(
            port=[a[:3] for a in port], jax=[a[:3] for a in ref],
            ids=ids.numpy()[:3], hidden=hidden.numpy()[:3],
            dispatch=[(t[:3], w[:3]) for t, w in maps])
    return out


@pytest.fixture(scope="module", params=GRIDS,
                ids=[f"{d}x{m}" for d, m in GRIDS])
def grid(request, cases, tmp_path_factory):
    """One spawn of the grid running every case, then ``launch.serve
    --mesh`` for whisper and the VLM: (grid, rank results), the ranks in
    order.  The JAX package's store writes the CKPT archs' parameters,
    which every rank restores by ``param_shardings``."""
    d, m = request.param
    tmp = tmp_path_factory.mktemp(f"slots{d}x{m}")
    ckpts = {}
    for arch in CKPT:
        name = case_name(arch, 4)
        ckpts[name] = str(tmp / arch)
        jax_save_checkpoint(ckpts[name], 1, cases[name]["params"])
    job = dict(mode="lm", ckpts=ckpts, cases=[
        dict(name=k, cfg=c["cfg"], params=c["params"], tokens=c["tokens"],
             steps=c["steps"], source=c["source"], max_cache_len=CACHE,
             gen=GEN)
        for k, c in cases.items() if c["tokens"].shape[0] in batches((d, m))])
    jobs = [("lm", job)] + [
        (arch, dict(mode="serve_cli", argv=["--mesh", f"{d}x{m}", "--arch",
                                            arch] + CLI))
        for arch in SOURCED]
    res = spawn_ranks(d * m, m, str(tmp), {}, jobs)
    return (d, m), [r["lm"] | {"data_rank": r["data_rank"],
                               "model_rank": r["model_rank"],
                               "cli": {a: r[a] for a in SOURCED}}
                    for r in res]


def _arch(name: str) -> str:
    return name.split(" B=")[0]


def test_logits_match_the_one_process_port(grid, references):
    """Prefill and every decode step's logits, each rank's rows over the
    whole vocab, within 1e-5 of max|logit| of the one-process port on the
    same weights.  On the 1x1 grid every case is bitwise: a one-rank
    group's sums and gathers are the identity, the mamba2 norm's mean
    square is the sum over d_inner divided by it, and MoE combines every
    expert as the one-process port does."""
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
    """``model.forward(mesh=)`` with the source: each rank's rows of the
    final hidden states within 1e-5 of their max (bitwise on 1x1)."""
    for name, _, c in each_case(grid):
        want = references[name]["hidden"][c["rows"]]
        if grid[0] == (1, 1):
            np.testing.assert_array_equal(c["hidden"], want)
        assert rel(c["hidden"], want) <= 1e-5, name


def test_logits_match_jax(grid, references):
    """The same logits against the JAX package's prefill and decode_step
    on the same arrays, within 1e-5 of max|logit|."""
    for name, _, c in each_case(grid):
        for g, w in zip([c["prefill"]] + c["decode"],
                        references[name]["jax"]):
            assert rel(g, w[c["rows"]]) <= 1e-5, (name, rel(g, w[c["rows"]]))


def test_each_rank_holds_its_shard_bytes(grid, cases):
    """Parameter bytes a rank equal ``shard_bytes``, and every parameter
    block (the expert stacks, the mixers, the shared block and the encoder
    included) has the local shape of ``param_shardings``; every cache
    block (the conv and ssm states, wkv and the shifts, the shared and
    cross attention's rows included) that of ``cache_shardings``."""
    (d, m), _ = grid
    mesh = {"data": d, "model": m}
    for name, _, c in each_case(grid):
        cfg, b = cases[name]["cfg"], cases[name]["tokens"].shape[0]
        shape = ShapeSpec("decode", CACHE, b, "decode")
        assert c["param_bytes"] == specs.shard_bytes(cfg, shape,
                                                     mesh)["params"]
        pspec = dict(tree_leaves(specs.param_shardings(cfg, mesh)))
        for path, t in tree_leaves(TM.abstract_params(cfg)):
            assert c["param_shapes"][path] == local_shape(
                t.shape, pspec[path], mesh), (name, path)
        cspec = specs.cache_shardings(cfg, shape, mesh)
        abstract = TM.abstract_cache(cfg, b, CACHE)
        assert c["cache_shapes"].keys() == abstract.keys()
        for slot, leaves in c["cache_shapes"].items():
            assert leaves.keys() == abstract[slot].keys()
            for leaf, got in leaves.items():
                assert got == local_shape(abstract[slot][leaf].shape,
                                          cspec[slot][leaf], mesh), \
                    (name, slot, leaf)


def test_moe_dispatch_is_the_same_on_every_model_rank(grid, cases,
                                                       references):
    """Every model rank routes its rows alike: the prefill's tok_map and
    w_map of each MoE call are equal on the ranks of a data index; tok_map
    is the one-process port's on those rows, so the drops are its too (and
    there are some at capacity factor 0.5), and w_map within 1e-6 of it
    (the router reads a residual stream summed in another order)."""
    (d, m), ranks = grid
    moe_cases = [k for k in cases if cases[k]["cfg"].moe is not None]
    for name in moe_cases:
        if name not in ranks[0]["cases"]:
            continue
        cfg = cases[name]["cfg"]
        want = references[name]["dispatch"]
        assert len(want) == cfg.n_layers
        for r in ranks:
            c = r["cases"][name]
            first = ranks[r["data_rank"] * m]["cases"][name]["dispatch"]
            assert len(c["dispatch"]) == len(want)
            for (tok, w), (tok0, w0), (tok1, w1) in zip(c["dispatch"], first,
                                                        want):
                np.testing.assert_array_equal(tok, tok0)
                np.testing.assert_array_equal(w, w0)
                np.testing.assert_array_equal(tok, tok1[c["rows"]])
                np.testing.assert_allclose(w, w1[c["rows"]], rtol=0,
                                           atol=1e-6)
        rows_of = {r["data_rank"]: r["cases"][name]["dispatch"]
                   for r in ranks}
        got = sum(_dropped(maps, cfg.moe.top_k) for maps in rows_of.values())
        if cases[name]["tokens"].shape[0] % d:     # rows not split
            got //= d
        assert got == _dropped(want, cfg.moe.top_k), name
    drops = _dropped(references[case_name("mixtral-8x22b", 4)]["dispatch"],
                     2)
    assert drops > 0


def test_generate_with_a_source_on_the_grid(grid, references):
    """``generate(mesh=)`` with the source: global ids on every rank, each
    the cross-rank argmax of the grid's own logits at that step; on the
    1x1 grid the one-process port's ids."""
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


@pytest.fixture(scope="module")
def cli_ids():
    """{arch: the first two rows of the one-process ``generate`` on the
    serve CLI's draws from --seed 3 (the host generator's: the weights
    leaf by leaf in sorted key order, the prompt, then the frames or
    patches)}."""
    out = {}
    for arch in SOURCED:
        cfg = registry.smoke_config(arch)
        gen = torch.Generator().manual_seed(3)
        params = TM.init(cfg, gen)
        tokens = torch.randint(0, cfg.vocab_size, (4, 6), generator=gen)
        source = source_inputs(cfg, 4, gen)
        assert set(source) == ({"frames"} if cfg.encoder else {"patches"})
        out[arch] = generate(cfg, params, tokens, 3, generator=gen,
                             source=source)[0][:2].tolist()
    return out


@pytest.mark.parametrize("arch", SOURCED)
def test_serve_cli_with_a_source_on_the_grid(grid, cli_ids, arch):
    """``launch.serve --mesh DxM`` for whisper and the VLM on every rank:
    rank 0 prints the greedy ids of the one-process ``generate`` on the
    same draws, the others print nothing."""
    (d, m), ranks = grid
    assert all(r["cli"][arch]["rc"] == 0 for r in ranks)
    out = ranks[0]["cli"][arch]["out"].splitlines()
    assert f"({d}x{m} grid)" in out[0] and arch in out[0]
    rows = [[int(t) for t in line.split()[:-1]] for line in out[2:]]
    assert rows == cli_ids[arch]
    assert all(r["cli"][arch]["out"] == "" for r in ranks[1:])


@pytest.mark.parametrize("arch", CKPT)
def test_restore_resharded_places_every_leaf(grid, cases, arch):
    """A checkpoint written by the JAX package's store, restored on each
    rank by ``param_shardings``: the shared block and the mamba2 mixer
    (zamba2), the expert stacks (mixtral), the encoder and cross attention
    (whisper) come back as exactly the blocks the JAX specs give that rank,
    and as ``local_lm_params``' blocks."""
    (d, m), ranks = grid
    name = case_name(arch, 4)
    c = cases[name]
    for r in ranks:
        assert r["restored_equal"][name]
        want = jax_blocks(c["jcfg"], c["params"], {"data": d, "model": m},
                           {"data": r["data_rank"], "model": r["model_rank"]})
        got = dict(tree_leaves(r["restored"][name]))
        for path, w in tree_leaves(want):
            np.testing.assert_array_equal(got[path], w)


def _reduces(cfg) -> int:
    """All-reduces of a decode step where every compute dim is the
    rank's: the embedding, and each slot's row-parallel products (an
    attention slot's attention and MLP or MoE, mamba2's norm and
    out_proj, rwkv6's time and channel mix; shared and cross attention)."""
    per_slot = sum(2 + s.shared_attn + s.cross_attn
                   for s in cfg.layer_pattern)
    return 1 + cfg.n_groups * per_slot


def test_collectives_of_a_step(grid, cases):
    """Collectives always run: on a one-rank model group a decode step
    makes every all-reduce a larger group makes; on 1x1 nothing is
    gathered.  mamba2's in_proj output is all-gathered where its columns
    are on 'model' (1x2, 2x2, 1x4)."""
    (d, m), _ = grid
    for name, _, c in each_case(grid):
        cfg = cases[name]["cfg"]
        for step in c["collectives"][1:]:
            red = step.get("all_reduce", {}).get("calls", 0)
            assert red <= _reduces(cfg)
            if m == 1:
                assert red == _reduces(cfg), name
                if d == 1:
                    assert "all_gather" not in step
            if _arch(name) == "zamba2-7b" and m in (2, 4):
                # each mamba2 slot: its projection, conv_w, conv_b and the
                # conv cache gathered over 'model'
                assert step["all_gather"]["calls"] >= 4 * cfg.n_layers


LAYOUT_MESHES = ((1, 2), (2, 2), (1, 3), (1, 4), (1, 8), (16, 16))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_grid_layout_builds_for_every_arch(arch):
    """``GridLayout`` builds for every registry arch, smoke and full size,
    on every rank of grids from 1x2 to 16x16 (no process group is needed
    to build it), and its plans cover the model axis: the ranks' experts
    and ssm heads are disjoint ranges covering them all, a row-parallel
    product is summed exactly where its compute dim is on 'model'."""
    for cfg in (registry.smoke_config(arch), registry.get_config(arch)):
        for d, m in LAYOUT_MESHES:
            lays = [sharded.GridLayout(cfg, fake_mesh(d, m, 0, mi))
                    for mi in range(m)]
            for name in lays[0].slots:
                plans = [lay.slots[name] for lay in lays]
                for key, plan in plans[0].items():
                    if isinstance(plan, sharded.Ffn) and plan.experts:
                        got = [p[key].experts for p in plans]
                        per = cfg.moe.n_experts // m
                        assert got == [(i * per, (i + 1) * per)
                                       for i in range(m)]
                        assert plan.reduce
                    if isinstance(plan, sharded.Mamba):
                        got = [p[key].heads for p in plans]
                        h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
                        if plan.local:
                            assert got == [(i * h // m, (i + 1) * h // m)
                                           for i in range(m)]
                        else:
                            assert got == [(0, h)] * m
                    if isinstance(plan, sharded.Attn):
                        assert plan.reduce == (cfg.n_heads % m == 0)
            assert lays[0].gather.keys() == lays[0].spec.keys()


def test_expert_and_head_layouts_of_the_chip_grids():
    """The layouts ``chip_smoke.py`` phase 14 serves: mixtral-8x22b at
    1x4 holds 2 experts a rank and reads its own 2 kv heads; zamba2-7b at
    2x2 runs 56 ssm heads a rank with in_proj's output gathered, the
    shared block on 16 kv heads; rwkv6-1.6b at 1x4 8 heads a rank;
    whisper-large-v3 at 2x2 10 heads a rank in every attention, and its
    51866-entry vocab split at model 2 but not at model 4."""
    mix = sharded.GridLayout(registry.get_config("mixtral-8x22b"),
                             fake_mesh(1, 4, 0, 1))
    assert mix.slots["slot0"]["ffn"] == sharded.Ffn(True, (2, 4))
    assert mix.slots["slot0"]["attn"].kv_index is None
    zam = sharded.GridLayout(registry.get_config("zamba2-7b"),
                             fake_mesh(2, 2, 1, 1))
    assert zam.slots["slot0"]["mixer"] == sharded.Mamba((56, 112), True,
                                                        True)
    assert zam.shared == sharded.Attn(True, None)
    assert zam.gather["groups"]["slot0"]["mixer"]["conv_w"] == [2]
    rwk = sharded.GridLayout(registry.get_config("rwkv6-1.6b"),
                             fake_mesh(1, 4, 0, 3))
    assert rwk.slots["slot0"]["mixer"] == sharded.Rwkv(True, True)
    assert rwk.gather["groups"]["slot0"]["mixer"]["w_g"] == []
    whi = registry.get_config("whisper-large-v3")
    lay = sharded.GridLayout(whi, fake_mesh(2, 2, 0, 1))
    assert lay.encoder["attn"] == sharded.Attn(True, None)
    assert lay.slots["slot0"]["cross_attn"] == sharded.Attn(True, None)
    assert lay.vocab_on and lay.vocab_lo == whi.vocab_size // 2
    assert not sharded.GridLayout(whi, fake_mesh(1, 4, 0, 1)).vocab_on
