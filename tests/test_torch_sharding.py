"""The port's sharding rules engine (``repro_torch.sharding``) and the spec
trees of ``launch/specs.py`` against the JAX package's: every leaf of every
(arch x allowed shape) cell on the production meshes and on small grids,
spec for spec and decision log for decision log; the rules' examples and
invariant; ``shard_bytes`` against the bytes the JAX specs imply."""
import math

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import registry as jax_registry
from repro.launch import specs as JS
from repro.models import model as JM
from repro.sharding import spec_for as jax_spec_for
from repro_torch.configs import SHAPES, registry
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.models.params import tree_leaves
from repro_torch.sharding import (RULES, axis_sizes, local_block,
                                  local_shape, spec_for, tree_shardings)

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2}, "2x1": {"data": 2, "model": 1},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "1x3": {"data": 1, "model": 3}}


class FakeMesh:
    """Duck-typed JAX mesh: axis_names + devices.shape is all spec_for
    reads."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


def _jax_leaves(axes_tree, shape_tree):
    """{keystr path: (axes, shape)} of a JAX axes tree and its shapes."""
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    axes = dict((jax.tree_util.keystr(p), a) for p, a in
                jax.tree_util.tree_flatten_with_path(axes_tree,
                                                     is_leaf=is_axes)[0])
    shapes = dict((jax.tree_util.keystr(p), tuple(s.shape)) for p, s in
                  jax.tree_util.tree_flatten_with_path(shape_tree)[0])
    assert axes.keys() == shapes.keys()
    return {k: (axes[k], shapes[k]) for k in axes}


def _port_leaves(axes_tree, shape_tree):
    shapes = dict(tree_leaves(shape_tree))
    return {p: (a, tuple(shapes[p].shape)) for p, a in tree_leaves(axes_tree)}


def _trees(arch: str):
    """[(what, JAX leaves, port leaves)] of every tree of one arch: the
    parameters, and for each allowed shape its batch and decode cache."""
    jcfg, cfg = jax_registry.get_config(arch), registry.get_config(arch)
    out = [("params", _jax_leaves(JM.param_axes(jcfg),
                                  JM.abstract_params(jcfg)),
            _port_leaves(TM.param_axes(cfg), TM.abstract_params(cfg)))]
    for name, shape in SHAPES.items():
        if not registry.runs_shape(arch, name):
            continue
        jshape = JAX_SHAPES[name]
        b, s = shape.global_batch, shape.seq_len
        out.append((f"{name} batch",
                    _jax_leaves(JS.batch_axes(jcfg, jshape),
                                JS.batch_specs(jcfg, jshape)),
                    _port_leaves(specs.batch_axes(cfg, shape),
                                 specs.batch_specs(cfg, shape))))
        out.append((f"{name} cache",
                    _jax_leaves(JM.cache_axes(jcfg, b, s),
                                JM.abstract_cache(jcfg, b, s)),
                    _port_leaves(TM.cache_axes(cfg, b, s),
                                 TM.abstract_cache(cfg, b, s))))
    return out


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_for_equals_jax_on_every_leaf(arch):
    """Every leaf of ``param_axes``, ``batch_axes`` and ``cache_axes`` of
    every allowed shape, on the production meshes and the small grids:
    the port's spec equals the JAX PartitionSpec entry for entry, and its
    decision log the JAX function's, string for string."""
    for what, jax_leaves, port_leaves in _trees(arch):
        assert jax_leaves == port_leaves, what
        for mesh_name, sizes in MESHES.items():
            fake = FakeMesh(sizes)
            for path, (axes, shape) in port_leaves.items():
                jd, td = [], []
                want = tuple(jax_spec_for(axes, shape, fake, jd))
                assert spec_for(axes, shape, sizes, td) == want, \
                    (what, mesh_name, path)
                assert td == jd, (what, mesh_name, path)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_trees_of_specs_match_the_rules(arch):
    """``param_shardings``, ``cache_shardings`` and ``batch_shardings`` are
    ``spec_for`` over each tree's leaves, with the decision log of a whole
    tree in the JAX package's flattening order; a live ``Mesh`` reads as
    its axis sizes."""
    cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
    shape = SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    for sizes in MESHES.values():
        fake = FakeMesh(sizes)
        for got, axes, abstract in (
                (specs.param_shardings(cfg, sizes), TM.param_axes(cfg),
                 TM.abstract_params(cfg)),
                (specs.cache_shardings(cfg, shape, sizes),
                 TM.cache_axes(cfg, b, s), TM.abstract_cache(cfg, b, s)),
                (specs.batch_shardings(cfg, shape, sizes),
                 specs.batch_axes(cfg, shape),
                 specs.batch_specs(cfg, shape))):
            shapes = dict(tree_leaves(abstract))
            for path, spec in tree_leaves(got):
                ax = dict(tree_leaves(axes))[path]
                assert spec == spec_for(ax, shapes[path].shape, sizes)
        td, jd = [], []
        tree_shardings(TM.param_axes(cfg), TM.abstract_params(cfg), sizes,
                       td)
        for path, (ax, shp) in _jax_leaves(JM.param_axes(jcfg),
                                           JM.abstract_params(jcfg)).items():
            jax_spec_for(ax, shp, fake, jd)
        assert td == jd
    assert specs.vec_sharding(MESHES["2x2"], (8, 4), ("batch", None)) == \
        tuple(jax_spec_for(("batch", None), (8, 4), FakeMesh(MESHES["2x2"])))
    assert specs.scalar_sharding(MESHES["2x2"]) == ()
    assert specs.scalar_sharding(MESHES["2x2"], ("batch",)) == (None,)
    live = Mesh(data=2, model=4, data_rank=0, model_rank=0, data_group=None,
                model_group=None, device=torch.device("cpu"))
    assert axis_sizes(live) == {"data": 2, "model": 4}
    assert specs.param_shardings(cfg, live) == specs.param_shardings(
        cfg, {"data": 2, "model": 4})


POD, MULTIPOD = MESHES["16x16"], MESHES["2x16x16"]


@pytest.mark.parametrize("axes,shape,mesh,want", [
    # batch shards over pod and data
    (("batch", None), (256, 4096), MULTIPOD, (("pod", "data"), None)),
    (("batch", None), (256, 4096), POD, ("data", None)),
    # qwen3: 40 heads % 16 != 0 -> heads falls through, head_dim takes model
    (("embed", "heads", "head_dim"), (5120, 40, 128), POD,
     ("data", None, "model")),
    # per-tensor contention: batch grabs (pod, data); seq_shard -> model
    (("batch", "seq_shard", None, None), (128, 32768, 8, 128), MULTIPOD,
     (("pod", "data"), "model", None, None)),
    # ...but kv_heads/head_dim outrank seq_shard on a full cache tensor
    (("batch", "seq_shard", "kv_heads", "head_dim"), (128, 32768, 8, 128),
     MULTIPOD, (("pod", "data"), None, None, "model")),
    # batch=1 does not divide -> seq_shard wins the data axes (long_500k)
    (("batch", "seq_shard", "kv_heads", None), (1, 524288, 1, 256),
     MULTIPOD, (None, ("pod", "data"), None, None)),
    # llama4: 16 experts == model -> expert parallelism
    (("experts", "embed", "mlp"), (16, 5120, 8192), POD,
     ("model", "data", None)),
    # mixtral: 8 experts % 16 != 0 -> falls through; mlp gets model
    (("experts", "embed", "mlp"), (8, 6144, 16384), POD,
     (None, "data", "model")),
    # a live grid's linear data axis: (pod, data) resolves as ('data',)
    (("batch", None), (8, 4), {"data": 4, "model": 2}, ("data", None)),
], ids=["batch-multipod", "batch-pod", "heads-fallback", "contention-seq",
        "contention-kv", "batch1-seq", "experts-16", "experts-8",
        "live-data-axis"])
def test_rule_examples(axes, shape, mesh, want):
    """The JAX package's examples (tests/test_sharding_rules.py), one
    case each, and the same spec from the JAX function."""
    assert spec_for(axes, shape, mesh) == want
    assert tuple(jax_spec_for(axes, shape, FakeMesh(mesh))) == want
    assert jax_spec_for(axes, shape, FakeMesh(mesh)) == P(*want)


def test_decision_log():
    decisions = []
    spec_for(("heads",), (40,), POD, decisions)
    assert decisions == ["skip heads->('model',): 40 % 16 != 0"]
    with pytest.raises(ValueError, match="rank mismatch"):
        spec_for(("heads",), (40, 2), POD)


_LOGICAL = [name for name, _ in RULES if name is not None]


@given(st.lists(st.sampled_from(_LOGICAL + [None]), min_size=1, max_size=5),
       st.lists(st.sampled_from([1, 2, 3, 8, 16, 40, 96, 128, 256, 4096]),
                min_size=1, max_size=5))
@settings(max_examples=100, deadline=None)
def test_spec_never_reuses_a_mesh_axis(axes, shape):
    """No mesh axis is used twice in a spec, and every assignment divides
    its dim, on every mesh."""
    n = min(len(axes), len(shape))
    axes, shape = tuple(axes[:n]), tuple(shape[:n])
    for sizes in MESHES.values():
        spec = spec_for(axes, shape, sizes)
        used = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert len(used) == len(set(used)), (axes, shape, spec)
        for dim, e in zip(shape, spec):
            if e is not None:
                names = e if isinstance(e, tuple) else (e,)
                assert dim % math.prod(sizes[a] for a in names) == 0


def _jax_bytes(axes_tree, shape_tree, sizes, itemsize=None) -> int:
    """Bytes one device holds of a tree by the JAX package's specs."""
    fake, total = FakeMesh(sizes), 0
    leaves = _jax_leaves(axes_tree, shape_tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(shape_tree)[0]:
        axes, shape = leaves[jax.tree_util.keystr(path)]
        spec = jax_spec_for(axes, shape, fake)
        parts = math.prod(
            math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
            for e in spec if e is not None)
        size = itemsize or np.dtype(leaf.dtype).itemsize
        total += math.prod(shape) // parts * size
    return total


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_shard_bytes_match_the_jax_specs(arch):
    """``shard_bytes`` (local shapes of meta tensors) against the bytes the
    JAX package's specs imply: f32 parameters, AdamW's m and v and step for
    a train cell, the f32 decode cache and the batch."""
    cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
    for mesh_name in ("16x16", "2x16x16", "2x2", "1x3"):
        sizes = MESHES[mesh_name]
        for name, shape in SHAPES.items():
            if not registry.runs_shape(arch, name):
                continue
            jshape = JAX_SHAPES[name]
            b, s = shape.global_batch, shape.seq_len
            got = specs.shard_bytes(cfg, shape, sizes)
            pbytes = _jax_bytes(JM.param_axes(jcfg), JM.abstract_params(jcfg),
                                sizes)
            want = {"params": pbytes}
            if shape.kind == "train":
                want["opt_state"] = 2 * pbytes + 4
            if shape.kind == "decode":
                fake = FakeMesh(sizes)
                tok = jax_spec_for(("batch", None), (b, 1), fake)
                parts = 1 if tok[0] is None else math.prod(
                    sizes[a] for a in ((tok[0],) if isinstance(tok[0], str)
                                       else tok[0]))
                want["batch"] = 4 * 2 * (b // parts)
            else:
                want["batch"] = _jax_bytes(JS.batch_axes(jcfg, jshape),
                                           JS.batch_specs(jcfg, jshape),
                                           sizes)
            if shape.kind != "train":
                want["cache"] = _jax_bytes(JM.cache_axes(jcfg, b, s),
                                           JM.abstract_cache(jcfg, b, s),
                                           sizes, itemsize=4)
            want["total"] = sum(want.values())
            assert got == want, (mesh_name, name)


def test_abstract_params_hold_no_storage():
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        leaves = tree_leaves(TM.abstract_params(cfg, torch.bfloat16))
        assert all(t.is_meta and t.dtype == torch.bfloat16
                   for _, t in leaves)
        assert sum(t.numel() for _, t in leaves) == TM.count_params(cfg)
        assert all(t.is_meta for _, t in tree_leaves(
            TM.abstract_cache(cfg, 2, 64)))


def test_local_block_and_shape():
    """A rank's block: each entry's dim cut into its axis' parts, mine at
    my index; a (pod, data) entry is the linear data axis."""
    a = np.arange(4 * 6 * 8).reshape(4, 6, 8)
    for di in range(2):
        for mi in range(2):
            mesh = Mesh(data=2, model=2, data_rank=di, model_rank=mi,
                        data_group=None, model_group=None,
                        device=torch.device("cpu"))
            got = local_block(a, (("pod", "data"), None, "model"), mesh)
            np.testing.assert_array_equal(
                got, a[2 * di:2 * di + 2, :, 4 * mi:4 * mi + 4])
            np.testing.assert_array_equal(
                local_block(a, ("data", "model", None), mesh, dims=[1]),
                a[:, 3 * mi:3 * mi + 3])
    assert local_shape((4, 6, 8), ("data", None, "model"),
                       {"data": 2, "model": 4}) == (2, 6, 2)
    with pytest.raises(ValueError, match="does not split"):
        local_shape((3,), ("model",), {"model": 2})


# ---------------------------------------------------------------------------
# the collectives autograd sees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def collectives(request, tmp_path_factory):
    """``testing.multirank``'s ``collectives`` job on a 1 x n grid of gloo
    ranks: (n, each rank's record)."""
    from repro_torch.testing.multirank import spawn_ranks
    n = request.param
    res = spawn_ranks(n, n, str(tmp_path_factory.mktemp(f"coll{n}")), {},
                      [("c", dict(mode="collectives"))])
    return n, [r["c"] for r in res]


def test_each_collectives_backward_is_its_adjoint(collectives):
    """The sum over the ranks of <f(x), y> equals the sum over the ranks
    of <x, f^T(y)>, f^T(y) the gradient autograd gives, within 1e-6: the
    all-reduce's backward is an all-reduce, the all-gather's a
    reduce-scatter, keep-my-block's the block placed in zeros."""
    n, ranks = collectives
    for name in ("reduce_sum", "gather_dim", "keep_block"):
        lhs = sum(r[name]["fx_y"] for r in ranks)
        rhs = sum(r[name]["x_fty"] for r in ranks)
        assert abs(lhs - rhs) <= 1e-6 * max(abs(lhs), 1.0), (name, lhs, rhs)
    assert ranks[0]["gather_dim"]["shape"] == (3, 2 * n, 4)
    assert ranks[0]["keep_block"]["shape"] == (3, 2)


def test_collective_counts_cover_the_backward(collectives):
    """``collective_counts`` tallies each pass by kind: the all-reduce's
    backward is one more all-reduce of the same bytes, the all-gather's
    one reduce-scatter of the gathered bytes (float64), keep-my-block none
    in either pass."""
    n, ranks = collectives
    for r in ranks:
        ar, ag, kb = r["reduce_sum"], r["gather_dim"], r["keep_block"]
        assert ar["forward"] == ar["backward"] == {
            "all_reduce": {"calls": 1, "bytes": 3 * 5 * 8}}
        assert ag["forward"] == {"all_gather": {"calls": 1,
                                                "bytes": 3 * 2 * n * 4 * 8}}
        assert ag["backward"] == {"reduce_scatter": {
            "calls": 1, "bytes": 3 * 2 * n * 4 * 8}}
        assert kb["forward"] == kb["backward"] == {}


def test_inference_mode_calls_the_untracked_collectives(collectives):
    """Under ``inference_mode`` (serving) ``reduce_sum``, ``gather_dim``,
    ``gather_at_use`` and ``keep_block`` take the untracked in-place calls
    (``all_reduce_``, ``all_gather_dim``, a slice) and record no graph:
    serving's collectives are those of before."""
    _, ranks = collectives
    for r in ranks:
        assert r["inference"]["calls"] == ["all_reduce_", "all_gather_dim",
                                           "all_gather_dim"]
        assert not r["inference"]["grad_fn"]
