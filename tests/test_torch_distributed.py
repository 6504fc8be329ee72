"""The port's distributed KRR step against the JAX package on the CPU.

One-rank gloo group against JAX on a (1, 1) mesh (psum step fused and
split, with and without the layout; jacobi and nystrom at k = 1 and 4;
predict; the hash-join step on f32 and bf16 wires and its predict with
and without dedup), multi-rank gloo groups (2 x 1 and 2 x 2 ranks, spawned
through ``repro_torch.testing.multirank``, which imports no JAX) against the
JAX single-device psum step, and the rules: overflow policies, the f32
retry and ``SolveDivergedError``, nystrom refused on sharded data, no host
sync inside ``cg_iterations``, one sort per hash-join step, and the
``krr_train`` driver in both table modes.

Tolerances: betas, tables and predictions within 1e-5 of max|.| — the two
frameworks sum in other orders, and 8 CG iterations keep the rounding
from growing past that.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.compat import make_mesh
from repro.core import GammaPDF as JGamma, get_bucket_fn as jget
from repro.core import sample_lsh_params as jsample
from repro.core import distributed as JD
from repro_torch import core as T
from repro_torch.convert import lsh_from_reference
from repro_torch.core import distributed as D
from repro_torch.errors import SolveDivergedError, WireOverflowError
from repro_torch.launch import krr_train
from repro_torch.launch.mesh import Mesh, init_distributed, make_host_mesh
from repro_torch.testing.faults import FaultPlan
from repro_torch.testing.multirank import assemble, spawn_ranks

N, D_IN, M, B, NQ = 256, 3, 4, 1024, 64
CFG = dict(m=M, table_size=B, lam=0.5, cg_iters=8)


def _close(got, want, rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _data(k=0):
    key = jax.random.PRNGKey(0)
    x = np.asarray(jax.random.uniform(key, (N, D_IN)) * 8.0)
    y = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                     (N,) if k == 0 else (N, k)))
    xq = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3),
                                       (NQ, D_IN)) * 8.0)
    jl = jsample(jax.random.fold_in(key, 2), M, D_IN, JGamma(2.0, 1.0))
    return x, y, xq, jl


def _jcfg(**kw):
    return JD.KRRStepConfig(**dict(CFG, **kw), data_axes=("data",),
                            model_axis="model", backend="reference")


@functools.lru_cache(maxsize=None)
def _jax_psum(k=0, **kw):
    """The JAX package's psum step and predict on one device."""
    x, y, xq, jl = _data(k)
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg, f = _jcfg(**kw), jget("rect")
    beta, res, tables = jax.jit(JD.make_krr_step(mesh, cfg, f))(x, y, jl)
    pred = jax.jit(JD.make_krr_predict(mesh, cfg, f))(xq, jl, tables)
    return tuple(np.asarray(a) for a in (beta, res, tables, pred))


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo group for this module."""
    own = not dist.is_initialized()
    if own:
        store = tmp_path_factory.mktemp("pg") / "store"
        init_distributed("cpu", init_method=f"file://{store}", rank=0,
                         world_size=1)
    yield make_host_mesh(device="cpu")
    if own:
        dist.destroy_process_group()


def _port_lsh():
    return lsh_from_reference(_data()[3], "cpu")


@pytest.mark.parametrize("fused,blocked_split", [
    (True, True), (True, False), (False, True), (False, False)])
def test_psum_step_and_predict_match_jax(mesh, fused, blocked_split):
    """fused (B2 one pass), split off the layout (B3 + B6) and split
    without it (B5 + B4), each on one rank against JAX on a (1, 1) mesh."""
    x, y, xq, _ = _data()
    want = _jax_psum(fused=fused, blocked_split=blocked_split)
    cfg = D.KRRStepConfig(**CFG, fused=fused, blocked_split=blocked_split)
    step = D.make_krr_step(mesh, cfg, T.RECT)
    beta, res, tables = step(x, y, _port_lsh())
    _close(beta, want[0])
    _close(tables, want[2])
    np.testing.assert_allclose(float(res), want[1], rtol=1e-4)
    pred = D.make_krr_predict(mesh, cfg, T.RECT)(xq, _port_lsh(), tables)
    _close(pred, want[3])
    assert set(step.phase_ms()) == {"featurize", "layout", "cg", "tables"}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precond", ["jacobi", "nystrom"])
def test_preconditioned_step_matches_jax(mesh, precond, k):
    x, y, xq, _ = _data(k)
    kw = dict(precond=precond, precond_rank=32)
    want = _jax_psum(k, **kw)
    cfg = D.KRRStepConfig(**CFG, **kw)
    beta, res, tables = D.make_krr_step(mesh, cfg, T.RECT)(x, y, _port_lsh())
    _close(beta, want[0])
    np.testing.assert_allclose(res.numpy(), want[1], rtol=1e-4)
    _close(D.make_krr_predict(mesh, cfg, T.RECT)(xq, _port_lsh(), tables),
           want[3])


@functools.lru_cache(maxsize=None)
def _jax_hashjoin(wire, dedup):
    x, y, xq, jl = _data()
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg, f = _jcfg(), jget("rect")
    beta, res, table, stats = jax.jit(JD.make_krr_step_hashjoin(
        mesh, cfg, f, payload_dtype=wire))(x, y, jl)
    pred, dropped = jax.jit(JD.make_krr_predict_hashjoin(
        mesh, cfg, f, payload_dtype=wire, with_stats=True, dedup=dedup))(
        xq, jl, table)
    return tuple(np.asarray(a) for a in (beta, res, table, pred, dropped))


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_hashjoin_step_and_predict_match_jax(mesh, wire):
    """The hash-join step on one rank against JAX's: f32 wire within
    1e-5; bf16 wire within the JAX package's pinned band (1% relative L2
    of the f32 solve, and not equal to it) and 1% of JAX's own bf16 solve.
    Predictions with and without dedup, with their drop counts."""
    x, y, xq, _ = _data()
    jwire = jnp.float32 if wire == "f32" else jnp.bfloat16
    twire = torch.float32 if wire == "f32" else torch.bfloat16
    cfg = D.KRRStepConfig(**CFG)
    step = D.make_krr_step_hashjoin(mesh, cfg, T.RECT, payload_dtype=twire)
    beta, res, table, stats = step(x, y, _port_lsh())
    assert int(stats.overflow_dropped) == 0 == int(stats.wire_nonfinite)
    assert set(step.phase_ms()) == {"featurize", "layout", "routing", "cg",
                                    "tables"}
    assert table.shape == (M, B)
    b_ps = _jax_psum()[0]
    for dedup in (True, False):
        want = _jax_hashjoin(jwire, dedup)
        pred, dropped = D.make_krr_predict_hashjoin(
            mesh, cfg, T.RECT, payload_dtype=twire, with_stats=True,
            dedup=dedup)(xq, _port_lsh(), table)
        assert dropped.tolist() == want[4].tolist() == [0]
        if wire == "f32":
            _close(beta, want[0])
            _close(table, want[2])
            _close(pred, want[3])
            _close(beta, b_ps)
        else:
            rel = np.linalg.norm(beta.numpy() - b_ps) / np.linalg.norm(b_ps)
            assert 0.0 < rel < 1e-2, rel
            _close(beta, want[0], rel=1e-2)
            _close(pred, want[3], rel=1e-2)


def _spawned(world, model_parallel, tmp):
    x, y, xq, jl = _data()
    inputs = dict(x=x, y=y, xq=xq, **{k: np.asarray(v) for k, v in
                                      jl._asdict().items()})
    jobs = [("psum", dict(mode="psum", cfg=CFG)),
            ("psum_points", dict(mode="psum",
                                 cfg=dict(CFG, blocked_split=False))),
            ("jacobi", dict(mode="psum", cfg=dict(CFG, precond="jacobi"))),
            ("hj32", dict(mode="hashjoin", cfg=CFG, wire="f32")),
            ("hj16", dict(mode="hashjoin", cfg=CFG, wire="bf16"))]
    return spawn_ranks(world, model_parallel, tmp, inputs, jobs)


@pytest.mark.parametrize("world,model_parallel", [(2, 1), (4, 2)])
def test_multirank_steps_match_single_device_jax(tmp_path, world,
                                                 model_parallel):
    """2 x 1 and 2 x 2 rank grids (data x model) on gloo against the JAX
    package's single-device psum step: betas, tables and predictions of
    the psum step (split off the layout, and without it), jacobi, and the
    f32 hash join within 1e-5; the bf16 hash join within its band."""
    res = _spawned(world, model_parallel, str(tmp_path))
    beta, _, tables, pred = _jax_psum()
    for job in ("psum", "psum_points", "hj32"):
        _close(assemble(res, job, "beta"), beta)
    for job in ("psum", "psum_points"):
        _close(assemble(res, job, "tables"), tables)
        _close(assemble(res, job, "pred"), pred)
    _close(assemble(res, "jacobi", "beta"),
           _jax_psum(precond="jacobi")[0])
    _close(assemble(res, "hj32", "table"), tables)
    for dedup in (0, 1):
        _close(assemble(res, "hj32", f"pred_dedup{dedup}"), pred)
        assert not assemble(res, "hj32", f"pred_dropped{dedup}").any()
    b16 = assemble(res, "hj16", "beta")
    rel = np.linalg.norm(b16 - beta) / np.linalg.norm(beta)
    assert 0.0 < rel < 1e-2, rel
    assert int(assemble(res, "hj32", "dropped")) == 0


def _small_cfg(**kw):
    return D.KRRStepConfig(**dict(CFG, **kw))


@pytest.mark.parametrize("policy", ["raise", "warn", "allow"])
def test_overflow_policies(mesh, policy):
    """cap_factor 0.05 drops buckets past capacity: 'raise' raises
    WireOverflowError with the count, 'warn' warns, 'allow' passes; the
    drops are counted either way and the solve stays finite."""
    x, y, _, _ = _data()
    cfg = _small_cfg(overflow=policy)
    run = functools.partial(D.run_krr_step_resilient, mesh, cfg, T.RECT, x,
                            y, _port_lsh(), cap_factor=0.05,
                            payload_dtype=torch.float32)
    if policy == "raise":
        with pytest.raises(WireOverflowError) as ei:
            run()
        assert ei.value.dropped > 0
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        beta, res, _, stats = run()
    warned = [w for w in caught if "past the routing capacity"
              in str(w.message)]
    assert bool(warned) == (policy == "warn")
    assert int(stats.overflow_dropped) > 0
    assert bool(torch.isfinite(beta).all()) and bool(torch.isfinite(res))


def test_nan_wire_retries_on_f32_then_diverges(mesh):
    """A NaN cell on the bf16 wire deactivates the solve (resnorm NaN); the
    runner retries once on an f32 wire, which runs clean when only bf16 is
    poisoned.  Poison on both wires ends in SolveDivergedError."""
    x, y, _, _ = _data()
    plan = FaultPlan(wire_nan_frac=0.05, wire_nan_bf16_only=True, seed=1)
    cfg = _small_cfg(fault_plan=plan, overflow="allow")
    with pytest.warns(RuntimeWarning, match="retrying once"):
        beta, res, _, _ = D.run_krr_step_resilient(mesh, cfg, T.RECT, x, y,
                                                   _port_lsh())
    assert bool(torch.isfinite(res)) and bool(torch.isfinite(beta).all())
    _close(beta, _jax_psum()[0])
    cfg = _small_cfg(fault_plan=plan._replace(wire_nan_bf16_only=False),
                     overflow="allow")
    with pytest.warns(RuntimeWarning), \
            pytest.raises(SolveDivergedError) as ei:
        D.run_krr_step_resilient(mesh, cfg, T.RECT, x, y, _port_lsh())
    assert ei.value.fallbacks == ("wire:bf16->f32",)
    # a dropped-cell fault loses mass: counted as non-finite never, and the
    # solve stays finite
    cfg = _small_cfg(fault_plan=FaultPlan(wire_drop_frac=0.2, seed=2))
    beta, res, _, stats = D.make_krr_step_hashjoin(mesh, cfg, T.RECT)(
        x, y, _port_lsh())
    assert int(stats.wire_nonfinite) == 0 and bool(torch.isfinite(res))


def test_nystrom_refused_on_sharded_data(mesh):
    two = Mesh(data=2, model=1, data_rank=0, model_rank=0, data_group=None,
               model_group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="nystrom"):
        D.make_krr_step(two, _small_cfg(precond="nystrom"), T.RECT)
    with pytest.raises(ValueError, match="nystrom"):
        D.make_krr_step_hashjoin(mesh, _small_cfg(precond="nystrom"), T.RECT)
    with pytest.raises(ValueError, match="divisible"):
        D.make_krr_step_hashjoin(two._replace(data=3), _small_cfg(), T.RECT)


@pytest.mark.parametrize("mode", ["psum", "hashjoin"])
@pytest.mark.parametrize("k", [0, 4])
def test_cg_iterations_never_syncs_the_host(mesh, monkeypatch, mode, k):
    """``Tensor.item`` and ``Tensor.__bool__`` raise while the CG loop runs
    (jacobi, psum and hash-join matvecs): dead-column flags stay on the
    device."""
    x, y, _, jl = _data(k)
    cfg = _small_cfg(precond="jacobi")
    op = T.WLSHOperator(lsh=lsh_from_reference(jl, "cpu"), bucket=T.RECT,
                        table_size=B, fused=False)
    idx = op.build_index(op.featurize(x), blocked=True, parts="both")
    if mode == "psum":
        mv = functools.partial(D.make_distributed_matvec(cfg, op, mesh=mesh),
                               idx)
    else:
        rt = D._build_routing(idx.slot, idx.blocked, mesh, B, 2.0)
        mv = lambda v: D._hashjoin_matvec(rt, idx.blocked, M, mesh, v,
                                          torch.bfloat16)
    pre = D._shard_preconditioner(cfg, mesh, None, idx)
    yt = torch.from_numpy(np.array(y))

    def host_sync(*a, **kw):
        raise AssertionError("host sync inside cg_iterations")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "item", host_sync)
        mp.setattr(torch.Tensor, "__bool__", host_sync)
        beta, res = D.cg_iterations(mv, yt, cfg, mesh, precond_apply=pre)
    assert bool(torch.isfinite(res).all())


def test_hashjoin_step_sorts_once(mesh, monkeypatch):
    """One stable sort per hash-join step: the layout's (the routing and
    the serve map ride it through searchsorted)."""
    x, y, _, _ = _data()
    calls = []
    real_sort = torch.sort

    def counting_sort(*a, **kw):
        calls.append(1)
        return real_sort(*a, **kw)

    monkeypatch.setattr(torch, "sort", counting_sort)
    D.make_krr_step_hashjoin(mesh, _small_cfg(), T.RECT)(x, y, _port_lsh())
    assert len(calls) == 1


@pytest.mark.parametrize("table_mode", ["psum", "hashjoin"])
def test_krr_train_runs_on_the_cpu(mesh, capsys, table_mode):
    """The driver in-process on the one-rank group, tiny scale."""
    assert krr_train.main([
        "--device", "cpu", "--dataset", "wine", "--scale", "0.03",
        "--m", "8", "--cg-iters", "5", "--table-mode", table_mode,
        "--num-rhs", "2"]) == 0
    out = capsys.readouterr().out
    assert f"table_mode={table_mode}" in out and "test RMSE" in out
    assert dist.is_initialized()          # the driver leaves our group up

