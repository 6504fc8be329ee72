"""The port's sharded serving tier against the JAX package's
(tests/test_serving_sharded.py): piece-grid artifacts that load in both
packages, the per-shard cache key, and the SPMD ``ShardedPredictor`` on
gloo grids of CPU ranks.

Inputs come from a numpy seed; the LSH instances are drawn once (numpy)
and the port fits the model, which both packages then load.

Exactness pins:
* a piece grid exported by either package reassembles in the other
  BITWISE (tables, LSH rows, normalization); the refusals (mesh mismatch,
  newer format, torn and mixed exports, poisoned pieces) match;
* on one model rank (1x1, 1x2) the sharded predictor is BITWISE the
  port's single-host ``Predictor`` (the exchanged values combine through
  the readout, in its order), with normalization too; on two model ranks
  (2x1, 2x2) within 1e-5 of max|pred|; against the JAX ``Predictor``
  within 1e-5 of max|pred| on every grid; the dedup and broadcast routes
  bitwise with each other;
* one spawn per grid (``testing.multirank``'s serve job) runs every
  multi-rank check: placement co-serving, cache replay and per-shard
  invalidation, overflow counters, chunking, non-finite rejection, the
  lifecycle's canary, torn and mixed publishes, swap and rollback, and
  ``krr_serve --selftest --mesh`` on the grid.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import core as T
from repro_torch.core.distributed import query_shard_touch
from repro_torch.errors import FaultInjected, InvalidRequest, ServingError
from repro_torch.serve import (MANIFEST_NAME, Normalization, Predictor,
                               ShardedPredictor, export_artifact,
                               export_artifact_sharded, load_artifact,
                               load_artifact_piece, load_artifact_sharded,
                               parse_mesh_shape)
from repro_torch.serve.cache import BucketKeyFn
from repro_torch.testing.faults import (killed_checkpoint_writer,
                                        mixed_generation_publish, nan_piece)
from repro_torch.testing.multirank import spawn_ranks

N, D, M = 256, 4, 16


def _fit(seed, k_rhs=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (N, D)).astype(np.float32)
    y = rng.standard_normal((N, k_rhs) if k_rhs else N).astype(np.float32)
    lsh = T.sample_lsh_params(rng, M, D, T.GammaPDF(2.0, 1.0), device="cpu")
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT),
                           lam=0.5, maxiter=100, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def fitted():
    return _fit(0)


@pytest.fixture(scope="module")
def fitted_k3():
    return _fit(3, k_rhs=3)


def _norm(x):
    return Normalization(x_mean=x.mean(0), x_std=x.std(0) + 0.5,
                         y_mean=0.3, y_std=1.7)


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A one-rank gloo group for the single-process predictors."""
    own = not dist.is_initialized()
    if own:
        from repro_torch.launch.mesh import init_distributed
        store = tmp_path_factory.mktemp("pg") / "store"
        init_distributed("cpu", init_method=f"file://{store}", rank=0,
                         world_size=1)
    yield
    if own:
        dist.destroy_process_group()


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# sharded artifacts: round trips within and across the packages, refusals
# ---------------------------------------------------------------------------

def test_sharded_roundtrip_bitwise(fitted, tmp_path):
    model, x = fitted
    norm = _norm(x)
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2),
                            norm=norm)
    loaded = load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2),
                                   device="cpu")
    assert torch.equal(loaded.model.tables, model.tables)
    for a, b in zip(loaded.model.lsh, model.lsh):
        assert torch.equal(a, b)
    assert loaded.model.beta.shape[0] == 0
    np.testing.assert_array_equal(loaded.norm.x_mean, norm.x_mean)
    np.testing.assert_array_equal(loaded.norm.x_std, norm.x_std)
    assert loaded.norm.y_mean == np.float32(norm.y_mean)
    assert loaded.norm.y_std == np.float32(norm.y_std)
    assert loaded.mesh_shape == (2, 2)
    assert loaded.manifest["framework"] == "torch"


def test_sharded_roundtrip_multirhs(fitted_k3, tmp_path):
    model, _ = fitted_k3
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    loaded = load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2),
                                   device="cpu")
    assert loaded.model.tables.ndim == 3
    assert torch.equal(loaded.model.tables, model.tables)
    assert tuple(loaded.model.beta.shape) == (0, 3)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_port_export_loads_in_jax_bitwise(fitted, tmp_path, shape):
    from repro.serve import load_artifact_sharded as jax_load
    model, x = fitted
    norm = _norm(x)
    export_artifact_sharded(str(tmp_path), model, mesh_shape=shape,
                            norm=norm)
    got = jax_load(str(tmp_path), mesh_shape=shape)
    np.testing.assert_array_equal(np.asarray(got.model.tables),
                                  _host(model.tables))
    for name in ("w", "z", "r1", "r2"):
        np.testing.assert_array_equal(np.asarray(getattr(got.model.lsh, name)),
                                      _host(getattr(model.lsh, name)))
    np.testing.assert_array_equal(got.norm.x_mean, norm.x_mean)
    assert got.norm.y_std == np.float32(norm.y_std)
    # the JAX package's operator on the reassembled model answers the
    # golden queries the port recorded, within their tolerance
    golden = got.manifest["golden"]
    xg = ((np.asarray(golden["x"], np.float32) - norm.x_mean)
          / norm.x_std).astype(np.float32)
    op = got.operator
    yg = np.asarray(op.predict_from_buckets(op.featurize_buckets(xg),
                                            got.model.tables))
    yg = yg * np.float32(norm.y_std) + np.float32(norm.y_mean)
    assert np.abs(yg - np.asarray(golden["y"])).max() <= golden["tol"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_jax_export_loads_in_port_bitwise(fitted, tmp_path, shape):
    from repro.serve import export_artifact_sharded as jax_export
    from repro.serve import load_artifact as jax_load_flat
    model, x = fitted
    export_artifact(str(tmp_path / "flat"), model)
    jmodel = jax_load_flat(str(tmp_path / "flat")).model
    norm = _norm(x)
    jax_export(str(tmp_path / "grid"), jmodel, mesh_shape=shape, norm=norm)
    got = load_artifact_sharded(str(tmp_path / "grid"), mesh_shape=shape,
                                device="cpu")
    assert torch.equal(got.model.tables, model.tables)
    for a, b in zip(got.model.lsh, model.lsh):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.norm.x_std, norm.x_std)
    # and one rank's piece, as a serving rank reads it
    i, j = shape[0] - 1, shape[1] - 1
    piece = load_artifact_piece(str(tmp_path / "grid"), mesh_shape=shape,
                                piece=(i, j), device="cpu",
                                with_lsh_host=True)
    m_loc, spp = M // shape[0], model.table_size // shape[1]
    assert torch.equal(piece.table, model.tables[
        i * m_loc:(i + 1) * m_loc, j * spp:(j + 1) * spp])
    assert torch.equal(piece.lsh.w, model.lsh.w[i * m_loc:(i + 1) * m_loc])
    np.testing.assert_array_equal(piece.lsh_host["r2"], _host(model.lsh.r2))


def test_export_refuses_indivisible_grid(fitted, tmp_path):
    model, _ = fitted
    with pytest.raises(ValueError, match="not divisible"):
        export_artifact_sharded(str(tmp_path), model, mesh_shape=(3, 2))
    with pytest.raises(ValueError, match="not divisible"):
        export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 3))


def test_load_refuses_mesh_mismatch(fitted, tmp_path):
    model, _ = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    for target in ((1, 2), (2, 4), (4, 2)):
        with pytest.raises(ValueError, match="re-export"):
            load_artifact_sharded(str(tmp_path), mesh_shape=target,
                                  device="cpu")
        with pytest.raises(ValueError, match="re-export"):
            load_artifact_piece(str(tmp_path), mesh_shape=target,
                                piece=(0, 0), device="cpu")
    load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2), device="cpu")


def test_load_refuses_newer_format(fitted, tmp_path):
    model, _ = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 2))
    path = os.path.join(str(tmp_path), MANIFEST_NAME)
    with open(path) as fh:
        manifest = json.load(fh)
    manifest["format"] += 1
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(ValueError, match="newer"):
        load_artifact_sharded(str(tmp_path), mesh_shape=(1, 2), device="cpu")


def test_torn_first_export_loads_nothing(fitted, tmp_path):
    """A writer killed mid-piece on a first export leaves no manifest and a
    piece .tmp invisible to ``latest_step``: nothing loads, and a retry
    that never sees the manifest gives up with the same error."""
    model, _ = fitted
    with killed_checkpoint_writer(after_saves=2):
        with pytest.raises(FaultInjected):
            export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    assert not os.path.exists(os.path.join(str(tmp_path), MANIFEST_NAME))
    with pytest.raises(FileNotFoundError):
        load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2), device="cpu",
                              retries=2, retry_backoff_s=0.001)


def test_torn_reexport_never_assembles_mixed(fitted, tmp_path):
    """A re-export killed mid-grid leaves the old manifest beside some new
    pieces: the version cross-check refuses the mix, in the whole loader
    and in the per-rank one for a new piece; a clean re-export heals the
    grid at the next version past the last published manifest."""
    model, _ = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    with killed_checkpoint_writer(after_saves=2):
        with pytest.raises(FaultInjected):
            export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="mixed or torn"):
        load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="mixed or torn"):
        load_artifact_piece(str(tmp_path), mesh_shape=(2, 2), piece=(0, 0),
                            device="cpu")
    # a piece the killed export never reached is still the old one
    load_artifact_piece(str(tmp_path), mesh_shape=(2, 2), piece=(1, 1),
                        device="cpu")
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(2, 2))
    loaded = load_artifact_sharded(str(tmp_path), mesh_shape=(2, 2),
                                   device="cpu")
    assert loaded.manifest["export_version"] == 2


def test_load_refuses_poisoned_and_stale_pieces(fitted, tmp_path):
    model, _ = fitted
    export_artifact_sharded(str(tmp_path / "nan"), model, mesh_shape=(1, 2))
    nan_piece(str(tmp_path / "nan"), (0, 1))
    with pytest.raises(ValueError, match="non-finite"):
        load_artifact_sharded(str(tmp_path / "nan"), mesh_shape=(1, 2),
                              device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        load_artifact_piece(str(tmp_path / "nan"), mesh_shape=(1, 2),
                            piece=(0, 1), device="cpu")
    # the healthy piece still reads: the refusal is the failing rank's
    load_artifact_piece(str(tmp_path / "nan"), mesh_shape=(1, 2),
                        piece=(0, 0), device="cpu")
    mixed_generation_publish(str(tmp_path / "mixed"), model,
                             mesh_shape=(1, 2), stale=(0, 0))
    with pytest.raises(ValueError, match="mixed or torn"):
        load_artifact_sharded(str(tmp_path / "mixed"), mesh_shape=(1, 2),
                              device="cpu")


def test_the_jax_package_refuses_the_same_pieces(fitted, tmp_path):
    """The port's fault writers damage the format itself: the JAX loader
    refuses what the port refuses."""
    from repro.serve import load_artifact_sharded as jax_load
    model, _ = fitted
    export_artifact_sharded(str(tmp_path / "nan"), model, mesh_shape=(1, 2))
    nan_piece(str(tmp_path / "nan"), (0, 1))
    with pytest.raises(ValueError, match="non-finite"):
        jax_load(str(tmp_path / "nan"), mesh_shape=(1, 2))
    mixed_generation_publish(str(tmp_path / "mixed"), model,
                             mesh_shape=(1, 2), stale=(0, 1))
    with pytest.raises(ValueError, match="mixed or torn"):
        jax_load(str(tmp_path / "mixed"), mesh_shape=(1, 2))


# ---------------------------------------------------------------------------
# per-shard cache keys
# ---------------------------------------------------------------------------

def test_keys_with_touch_matches_operator_slots_and_jax(fitted):
    """The touch sets agree with ``query_shard_touch`` over the operator's
    own slots (computed independently), and keys and touch sets are the
    JAX package's, byte for byte."""
    from repro.serve.cache import BucketKeyFn as JaxKeyFn
    from repro.serve import load_artifact as jax_load
    model, x = fitted
    keyfn = BucketKeyFn(model.lsh, T.RECT)
    op = T.make_operator(model.lsh, T.RECT, model.table_size, device="cpu")
    q = x[:32]
    slots = _host(op.build_index(op.featurize(q), blocked=False).slot).T
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        export_artifact(tmp, model)
        jmodel = jax_load(tmp).model
    jkeyfn = JaxKeyFn(jmodel.lsh, jmodel_bucket(jmodel))
    for n_shards in (2, 4, 8):
        touch = query_shard_touch(slots, model.table_size, n_shards)
        keys = keyfn.keys_with_touch(q, table_size=model.table_size,
                                     n_shards=n_shards)
        assert keys == jkeyfn.keys_with_touch(
            q, table_size=model.table_size, n_shards=n_shards)
        for i, (_, touched) in enumerate(keys):
            assert tuple(np.nonzero(touch[i])[0].tolist()) == touched


def jmodel_bucket(jmodel):
    from repro.core import get_bucket_fn
    return get_bucket_fn(jmodel.bucket_name)


def test_keys_with_touch_bad_rows_touch_everything(fitted):
    model, x = fitted
    keyfn = BucketKeyFn(model.lsh, T.RECT)
    q = x[:4].copy()
    q[2, 0] = np.inf
    keys = keyfn.keys_with_touch(q, table_size=model.table_size, n_shards=4)
    assert keys[2][0].startswith(b"!raw")
    assert keys[2][1] == (0, 1, 2, 3)
    for i in (0, 1, 3):
        assert not keys[i][0].startswith(b"!raw")


def test_parse_mesh_shape():
    assert parse_mesh_shape("2x2") == (2, 2)
    assert parse_mesh_shape("8X32") == (8, 32)
    for bad in ("2", "2x", "ax2", "0x2", "2x-1"):
        with pytest.raises(ValueError):
            parse_mesh_shape(bad)


# ---------------------------------------------------------------------------
# the predictor on one rank (a group of one)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("kind", ["plain", "norm", "k3"])
def test_sharded_predictor_1x1_bitwise_vs_single_host(
        one_rank_group, fitted, fitted_k3, tmp_path, dedup, kind):
    """On one rank the exchanged values add exact zeros and combine
    through the readout: the sharded warm path is BITWISE the single-host
    Predictor, with normalization and a multi-RHS block too, across
    padding buckets and chunks."""
    model, x = fitted_k3 if kind == "k3" else fitted
    norm = _norm(x) if kind == "norm" else None
    export_artifact(str(tmp_path / "single"), model, norm=norm)
    export_artifact_sharded(str(tmp_path / "grid"), model, mesh_shape=(1, 1),
                            norm=norm)
    single = Predictor(device="cpu", max_batch=64)
    single.load(str(tmp_path / "single"))
    sharded = ShardedPredictor(mesh_shape=(1, 1), device="cpu", max_batch=64,
                               dedup=dedup)
    sharded.load(str(tmp_path / "grid"))
    for b in (1, 17, 64, 150):
        q = np.tile(x, (2, 1))[:b]
        np.testing.assert_array_equal(sharded.predict(q, use_cache=False),
                                      single.predict(q, use_cache=False))
    np.testing.assert_array_equal(sharded.predict(x[0], use_cache=False),
                                  single.predict(x[0], use_cache=False))


def test_sharded_predictor_validation(one_rank_group, fitted, tmp_path):
    model, _ = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 1))
    pred = ShardedPredictor(mesh_shape=(1, 1), device="cpu")
    piece = load_artifact_piece(str(tmp_path), mesh_shape=(1, 1),
                                piece=(0, 0), device="cpu",
                                with_lsh_host=True)
    with pytest.raises(ValueError, match="outside model axis"):
        pred.add_model(piece, placement=(0, 2))
    with pytest.raises(ValueError, match="outside model axis"):
        pred.load(str(tmp_path), placement=(1, 2))
    with pytest.raises(ValueError, match="power of two"):
        ShardedPredictor(mesh_shape=(1, 3), device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        ShardedPredictor(mesh_shape=(1, 1), device="cpu", max_batch=48)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ShardedPredictor(mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="heartbeat_s"):
        ShardedPredictor(mesh_shape=(1, 1), device="cpu", heartbeat_s=0)
    with pytest.raises(ValueError, match="artifact sharded for mesh"):
        pred.add_model(piece._replace(mesh_shape=(1, 2)))
    # add_model hosts this rank's piece, never a whole loaded artifact
    with pytest.raises(TypeError, match="LoadedPiece"):
        pred.add_model(load_artifact_sharded(str(tmp_path), mesh_shape=(1, 1),
                                             device="cpu"))
    # a piece hosted directly serves like one load() reads
    aid = pred.add_model(piece, artifact_id="whole")
    pred.load(str(tmp_path), artifact_id="piece")
    q = np.random.default_rng(1).uniform(0, 2, (9, D)).astype(np.float32)
    np.testing.assert_array_equal(pred.predict(q, artifact_id=aid),
                                  pred.predict(q, artifact_id="piece"))
    # once the grid serves, add_model (collective) is refused
    with pytest.raises(ServingError, match="collective"):
        pred.add_model(piece, artifact_id="late")
    pred.stop()


def test_sharded_cache_replay_and_bump(one_rank_group, fitted, tmp_path):
    """Hits replay the cold path bitwise; bumping a shard's piece version
    invalidates exactly the entries touching it (on one data shard, all)."""
    model, x = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 1))
    pred = ShardedPredictor(mesh_shape=(1, 1), device="cpu",
                            cache_entries=1024)
    pred.load(str(tmp_path))
    q = x[:8]
    cold = pred.predict(q)
    np.testing.assert_array_equal(pred.predict(q), cold)
    stats = pred.cache_stats()
    assert stats["hits"] >= len(q)
    before = stats["misses"]
    pred.bump_shard_version(0)
    np.testing.assert_array_equal(pred.predict(q), cold)
    assert pred.cache_stats()["misses"] == before + len(q)
    with pytest.raises(ValueError, match="outside"):
        pred.bump_shard_version(1)
    assert pred.health()["shards"][pred.artifact_ids[0]][
        "piece_versions"] == [1]
    pred.clear_cache()
    assert pred.cache_stats()["entries"] == 0


def test_sharded_predictor_rejects_nonfinite(one_rank_group, fitted,
                                             tmp_path):
    model, x = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 1))
    pred = ShardedPredictor(mesh_shape=(1, 1), device="cpu")
    pred.load(str(tmp_path))
    q = x[:4].copy()
    q[1, 2] = np.nan
    with pytest.raises(InvalidRequest):
        pred.predict(q)
    assert pred.health()["errors"] == 1


def test_sharded_predictor_bucket_count_bound(one_rank_group, fitted,
                                              tmp_path):
    """Ragged sizes within one padding bucket run no new bucket."""
    model, x = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 1))
    pred = ShardedPredictor(mesh_shape=(1, 1), device="cpu", max_batch=64)
    pred.load(str(tmp_path))
    pred.warmup(sizes=(1, 16))
    n0 = pred.compile_count()
    for b in (9, 12, 16, 3, 1):      # buckets 16, 16, 16, 4 (new), 1
        pred.predict(x[:b], use_cache=False)
    assert pred.compile_count() == n0 + 1


def test_sharded_predictor_stops_and_unloads(one_rank_group, fitted,
                                             tmp_path):
    from repro_torch.errors import ServingError
    model, x = fitted
    export_artifact_sharded(str(tmp_path), model, mesh_shape=(1, 1))
    with ShardedPredictor(mesh_shape=(1, 1), device="cpu") as pred:
        aid = pred.load(str(tmp_path))
        pred.predict(x[:3])
        assert pred.unload(aid) and not pred.unload(aid)
        with pytest.raises(KeyError):
            pred.predict(x[:3])
        pred.load(str(tmp_path))
        with pytest.raises(ServingError):
            pred.serve_forever()        # rank 0 fronts; it never works
    assert not pred.health()["ok"]
    with pytest.raises(ServingError, match="stopped"):
        pred.predict(x[:3])


# ---------------------------------------------------------------------------
# gloo grids: one spawn per grid runs every multi-rank check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(1, 2), (2, 1), (2, 2)],
                ids=lambda s: f"{s[0]}x{s[1]}")
def grid(request, fitted, fitted_k3, tmp_path_factory):
    """Export every artifact the serve job reads, spawn the grid's ranks
    once, and hand back rank 0's record, every rank's, and the paths."""
    mm, nd = request.param
    model, x = fitted
    model_k3, _ = fitted_k3
    model_b, _ = _fit(7)
    tmp = tmp_path_factory.mktemp(f"grid{mm}x{nd}")
    norm = _norm(x)
    paths = {}
    for tag, mdl, nrm in (("", model, None), ("_norm", model, norm),
                          ("_k3", model_k3, None)):
        paths["flat" + tag] = str(tmp / f"flat{tag}")
        export_artifact(paths["flat" + tag], mdl, norm=nrm)
        paths["grid" + tag] = str(tmp / f"grid{tag}")
        export_artifact_sharded(paths["grid" + tag], mdl,
                                mesh_shape=(mm, nd), norm=nrm)
    paths["flat_b"] = str(tmp / "flat_b")
    export_artifact(paths["flat_b"], model_b)
    paths["half"] = str(tmp / "half")
    export_artifact_sharded(paths["half"], model, mesh_shape=(1, nd))
    paths["root"] = str(tmp / "versions")
    xq = np.random.default_rng(11).uniform(0.0, 2.0, (64, D)).astype(
        np.float32)
    lsh = {k: _host(v) for k, v in zip(("w", "z", "r1", "r2"), model.lsh)}
    inputs = dict(x=x, y=np.zeros(N, np.float32), xq=xq, **lsh)
    serve = dict(mode="serve", xq=xq, **paths)
    argv = ["--selftest", "--device", "cpu", "--mesh", f"{mm}x{nd}"]
    jobs = [("serve", serve),
            ("krr_serve", dict(mode="krr_serve", argv=argv))]
    results = spawn_ranks(mm * nd, mm, str(tmp), inputs, jobs)
    return dict(shape=(mm, nd), res=results[0]["serve"], ranks=results,
                paths=paths, xq=xq, model=model, model_b=model_b)


# the group's collective timeout in the faults spawn, the heartbeat and
# the idle spell (past the timeout)
FAULT_TIMEOUT_S, FAULT_HEARTBEAT_S, FAULT_IDLE_S = 5.0, 0.5, 6.5


@pytest.fixture(scope="module")
def faults(fitted, tmp_path_factory):
    """A 1x2 grid on a gloo group whose collectives time out after
    FAULT_TIMEOUT_S: ``_serve_faults_job`` idles past it, then has the
    worker's share of a predict fail."""
    model, x = fitted
    tmp = tmp_path_factory.mktemp("faults")
    path = str(tmp / "grid")
    export_artifact_sharded(path, model, mesh_shape=(1, 2))
    single = str(tmp / "flat")
    export_artifact(single, model)
    xq = np.random.default_rng(12).uniform(0.0, 2.0, (16, D)).astype(
        np.float32)
    lsh = {k: _host(v) for k, v in zip(("w", "z", "r1", "r2"), model.lsh)}
    inputs = dict(x=x, y=np.zeros(N, np.float32), xq=xq, **lsh)
    spec = dict(mode="serve_faults", grid=path, xq=xq,
                heartbeat_s=FAULT_HEARTBEAT_S, idle_s=FAULT_IDLE_S)
    ranks = spawn_ranks(2, 1, str(tmp), inputs, [("faults", spec)],
                        timeout_s=FAULT_TIMEOUT_S)
    want = Predictor(device="cpu")
    want.load(single)
    return ranks, want.predict(xq, use_cache=False)


def test_idle_grid_outlives_the_collective_timeout(faults):
    """Rank 0 idles past the group's collective timeout; the heartbeat
    keeps the worker's wait short, and the grid serves the same bits."""
    ranks, want = faults
    res = ranks[0]["faults"]
    np.testing.assert_array_equal(res["before"], want)
    np.testing.assert_array_equal(res["after_idle"], want)


def test_worker_failure_fails_the_predict_on_rank0(faults):
    """A worker whose share of a predict raises fails rank 0's predict
    with its error (no rank waits in a collective), and serves on."""
    ranks, want = faults
    res = ranks[0]["faults"]
    assert res["fault"] is not None and "rank 1 failed" in res["fault"]
    assert res["errors"] == 1
    np.testing.assert_array_equal(res["after_fault"], want)
    assert ranks[1]["faults"]["worker_error"] == res["fault"].split(
        ": ", 1)[1]


def _close(got, want):
    """Within 1e-5 of max|want|."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_grid_matches_port_predictor(grid):
    """Bitwise on one model rank; within 1e-5 of max|pred| on two."""
    res, (mm, _) = grid["res"], grid["shape"]
    for tag in ("", "_norm", "_k3"):
        got, want = res["pred" + tag], res["single" + tag]
        assert got.shape == want.shape
        if mm == 1:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(res["one_row" + tag], want[0])
        else:
            _close(got, want)
            _close(res["one_row" + tag], want[0])


def test_grid_matches_jax_predictor(grid):
    from repro.serve import Predictor as JaxPredictor
    res = grid["res"]
    jp = JaxPredictor(cache_entries=0)
    for tag in ("", "_norm", "_k3"):
        aid = jp.load(grid["paths"]["flat" + tag])
        _close(res["pred" + tag],
               np.asarray(jp.predict(grid["xq"], artifact_id=aid,
                                     use_cache=False)))


def test_grid_dedup_route_bitwise_with_broadcast(grid):
    """dedup=True at max_batch 16 on 50 rows (16+16+16+2 chunks) against
    the broadcast route's rows: the same bits."""
    res = grid["res"]
    np.testing.assert_array_equal(res["dedup_chunked"], res["pred"][:50])
    assert sum(res["overflow_dedup"]) == 0


def test_grid_each_rank_holds_its_own_piece(grid):
    """The rank at (data j, model r) holds piece (r, j): its tables and
    LSH rows are that slice of the model's."""
    mm, nd = grid["shape"]
    model = grid["model"]
    m_loc, spp = M // mm, model.table_size // nd
    seen = set()
    for r in grid["ranks"]:
        i, j = r["model_rank"], r["data_rank"]
        share = r["serve"]["pieces"]
        assert share["piece"] == (i, j)
        np.testing.assert_array_equal(
            share["table"], _host(model.tables)[i * m_loc:(i + 1) * m_loc,
                                                j * spp:(j + 1) * spp])
        np.testing.assert_array_equal(
            share["w"], _host(model.lsh.w)[i * m_loc:(i + 1) * m_loc])
        seen.add((i, j))
    assert seen == {(i, j) for i in range(mm) for j in range(nd)}


def test_grid_placement_co_serving(grid):
    """Two model ranks: a one-model-rank export on rows [1, 2) serves the
    same bits as on rows [0, 1).  One model rank: a placement past the
    model axis is refused before any rank loads."""
    res, (mm, _) = grid["res"], grid["shape"]
    if mm == 1:
        assert res["placement_refused"]
        return
    np.testing.assert_array_equal(res["placed"], res["placed0"])
    assert res["placement"] == [1, 2]


def test_grid_cache_replay_and_bump(grid):
    res = grid["res"]
    assert res["cache_hit_equal"] and res["cache_after_bump_equal"]
    assert res["bump_misses"] == res["touch0"]
    assert res["bump_hits"] == 16 - res["touch0"]
    assert res["piece_versions"][0] == 1 and not any(
        res["piece_versions"][1:])


def test_grid_overflow_counters(grid):
    """A starved dedup capacity accounts dropped buckets per shard; the
    broadcast route cannot overflow."""
    res, (_, nd) = grid["res"], grid["shape"]
    assert len(res["overflow_starved"]) == nd
    assert sum(res["overflow_starved"]) > 0
    assert res["overflow_bcast"] == [0] * nd


def test_grid_rejects_nonfinite_and_bounds_buckets(grid):
    res, (_, nd) = grid["res"], grid["shape"]
    assert res["nonfinite_rejected"]
    want = set(res["buckets_before"]) | {
        max(nd, 1 << (b - 1).bit_length()) for b in (9, 12, 16, 3, 1)}
    assert sorted(want) == res["buckets_after"]
    assert res["unloaded"]


def test_grid_lifecycle(grid):
    """Canary, torn publish, refused pieces, swap and rollback on the
    grid: v2 (one piece scaled) canary-rejected, v3 (pieces, no manifest)
    invisible, v4 (a NaN piece) and v5 (a stale piece) refused on load, v6
    swapped in, rollback() to v1, whose answers come back bit for bit."""
    res, (mm, _) = grid["res"], grid["shape"]
    assert res["life_steps"] == [
        ("v1", "swap", 1), ("v2 poisoned piece", "canary_reject", 1),
        ("v3 torn", "none", 1), ("v4 nan piece", "load_rejected", 1),
        ("v5 mixed generations", "load_rejected", 1), ("v6", "swap", 6),
        ("rollback()", "rollback", 1)]
    assert res["life_rejected"] == [2, 4, 5, 6]
    np.testing.assert_array_equal(res["life_v1"], res["pred"])
    np.testing.assert_array_equal(res["life_after_rollback"], res["pred"])
    assert res["life_models"] == ["v1"]
    single_b = Predictor(device="cpu")
    single_b.load(grid["paths"]["flat_b"])
    want = single_b.predict(grid["xq"], use_cache=False)
    if mm == 1:
        np.testing.assert_array_equal(res["life_v6"], want)
    else:
        _close(res["life_v6"], want)


def test_grid_krr_serve_selftest(grid):
    """``krr_serve --selftest --mesh`` on the grid: rank 0 serves, the
    others run the worker loop; every rank exits 0."""
    assert [r["krr_serve"]["rc"] for r in grid["ranks"]] == \
        [0] * len(grid["ranks"])
    assert "sharded selftest ok" in grid["ranks"][0]["krr_serve"]["out"]
