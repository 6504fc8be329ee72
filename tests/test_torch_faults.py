"""The chaos cases of ``tests/test_faults.py`` that no other torch test
pins, each on that test's own inputs (drawn by the JAX package): the
poisoned matvec column (``repro_torch.testing.poison_matvec``, against the
JAX package's wrapper and clean solve), the NaN target column under
``nonfinite_targets='deactivate'``, the broken preconditioner's restart
with the identity (in both packages), the checkpoint writer killed
mid-save during a fit, an unknown overflow policy (in both packages), and
the stalled shard.

Tolerances: where the two packages solve the same system they sum in
another order; each assertion says by how much they may differ and why.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import WLSHKernelSpec as JSpec, get_bucket_fn as jget
from repro.core import GammaPDF as JGamma, sample_lsh_params as jsample
from repro.core import distributed as JD
from repro.core import krr as jkrr
from repro.testing import poison_matvec as jpoison
from repro_torch import core as T
from repro_torch.checkpoint import latest_step
from repro_torch.convert import lsh_from_reference
from repro_torch.core import distributed as D
from repro_torch.core import krr as tkrr
from repro_torch.errors import FaultInjected
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.testing import (FaultPlan, killed_checkpoint_writer,
                                 poison_matvec)


def _spd_problem(n=64, k=3, seed=0):
    """``test_faults._spd_problem``: the JAX draws, as numpy."""
    key = jax.random.PRNGKey(seed)
    a = jax.random.normal(key, (n, n))
    a = a @ a.T / n + jnp.eye(n)
    b = jax.random.normal(jax.random.fold_in(key, 1), (n, k))
    return np.asarray(a), np.asarray(b)


def _fit_problem(n=384, d=3, seed=0, m=32):
    """``test_faults._fit_problem`` and the LSH parameters the JAX fit
    draws from its key (``sample_lsh_params(key, m, d, pdf, ell)``)."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    spec = JSpec(bucket=jget("rect"))
    jl = jsample(key, m, d, spec.pdf, spec.lengthscale)
    return key, np.asarray(x), np.asarray(y), spec, jl


SPEC = T.WLSHKernelSpec(bucket=T.RECT)


def test_poisoned_matvec_deactivates_column_others_converge():
    """``tests/test_faults.py``'s poisoned column on its inputs: NaN in
    column 1 of the matvec freezes that column at a finite iterate with a
    NaN resnorm, and the healthy columns are the clean solve's: the port's
    bitwise its own (the columns never mix), within 1e-6 of the JAX
    package's clean solve (a well-conditioned system: the two orders of
    the matmul sums move the converged iterates by rounding only)."""
    a, b = _spd_problem()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jclean = jkrr.pcg_solve(lambda v: ja @ v, jb, 0.5, tol=1e-8, maxiter=100)
    ta, tb = torch.tensor(a), torch.tensor(b)
    clean = T.pcg_solve(lambda v: ta @ v, tb, 0.5, tol=1e-8, maxiter=100)
    res = T.pcg_solve(poison_matvec(lambda v: ta @ v, column=1), tb, 0.5,
                      tol=1e-8, maxiter=100)
    assert bool(torch.isfinite(res.x).all())
    assert torch.isnan(res.resnorm[1])
    for j in (0, 2):
        assert bool(torch.isfinite(res.resnorm[j]))
        assert torch.equal(res.x[:, j], clean.x[:, j])
        np.testing.assert_allclose(res.x[:, j].numpy(),
                                   np.asarray(jclean.x[:, j]), atol=1e-6)


@pytest.mark.parametrize("column,k", [(0, 1), (1, 1), (2, 3)])
def test_poison_matvec_matches_the_jax_wrapper(column, k):
    """``poison_matvec`` is the JAX package's: NaN exactly where the JAX
    wrapper puts it (a vector's output is all NaN only for column 0), the
    rest the matvec's own output, the caller's tensor left as it was."""
    rng = np.random.default_rng(column)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    v = rng.standard_normal((8,) if k == 1 else (8, k)).astype(np.float32)
    want = np.asarray(jpoison(lambda u: jnp.asarray(a) @ u, column)(
        jnp.asarray(v)))
    ta = torch.from_numpy(a)
    seen = []
    got = poison_matvec(lambda u: seen.append(ta @ u) or seen[-1],
                        column)(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=1e-6)
    assert bool(torch.isfinite(seen[0]).all())


def test_nan_target_deactivate_mode_freezes_column():
    """``nonfinite_targets='deactivate'`` on ``test_faults``' inputs (a NaN
    in the second column's row 5): that column's resnorm is NaN, beta is
    finite, and the clean column is the clean single-RHS fit within 1e-4,
    the band the JAX test pins (the block matvec regroups sums, and 40
    iterations amplify them).  The port's clean fit is held to the JAX
    package's by ``test_torch_krr``."""
    _, x, y, _, jl = _fit_problem()
    yk = np.stack([y, y], axis=1)
    yk[5, 1] = np.nan
    kw = dict(lam=0.5, maxiter=40, device="cpu")
    lsh = lsh_from_reference(jl, "cpu")
    model = T.wlsh_krr_fit(lsh, x, yk, SPEC,
                           nonfinite_targets="deactivate", **kw)
    clean = T.wlsh_krr_fit(lsh, x, y, SPEC, **kw)
    assert bool(torch.isfinite(model.beta).all())
    last = model.telemetry["resnorm_history"][-1]
    assert np.isfinite(last[0]) and np.isnan(last[1])
    np.testing.assert_allclose(model.beta[:, 0].numpy(), clean.beta.numpy(),
                               atol=1e-4)


class _Poisoned:
    """A preconditioner whose apply returns NaN (either package's
    protocol: ``.apply(r)``)."""

    def apply(self, r):
        return r * float("nan")


def test_broken_preconditioner_falls_back_to_identity(monkeypatch):
    """``tests/test_faults.py``'s broken preconditioner in both packages:
    the first solve goes non-finite, the fit warns, restarts once with the
    identity and records ``precond:jacobi->identity``.  The port's beta is
    bitwise its own unpreconditioned fit (the restart is that solve) and
    within 1e-5 of max|beta| of the JAX package's restarted fit (7.0e-7
    measured: the two sum the matvec in another order)."""
    key, x, y, spec, jl = _fit_problem()
    kw = dict(lam=0.5, maxiter=40)
    monkeypatch.setattr(jkrr, "make_preconditioner",
                        lambda *a, **k: _Poisoned())
    with pytest.warns(RuntimeWarning, match="identity"):
        jmodel = jkrr.wlsh_krr_fit(key, x, y, spec, m=32,
                                   backend="reference", precond="jacobi",
                                   **kw)
    assert jmodel.solve_fallback == "precond:jacobi->identity"
    lsh = lsh_from_reference(jl, "cpu")
    clean = T.wlsh_krr_fit(lsh, x, y, SPEC, device="cpu", **kw)
    monkeypatch.setattr(tkrr, "make_preconditioner",
                        lambda *a, **k: _Poisoned())
    with pytest.warns(RuntimeWarning, match="identity"):
        model = T.wlsh_krr_fit(lsh, x, y, SPEC, device="cpu",
                               precond="jacobi", **kw)
    assert model.solve_fallback == "precond:jacobi->identity"
    assert bool(torch.isfinite(model.beta).all())
    assert torch.equal(model.beta, clean.beta)
    want = np.asarray(jmodel.beta)
    np.testing.assert_allclose(model.beta.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_preemption_mid_save_resumes_from_previous_chunk(tmp_path):
    """The checkpoint writer dies mid-save during a fit
    (``test_faults.test_preemption_mid_save_resumes_from_previous_chunk``):
    the fit raises, the newest complete state is the second chunk's
    (iteration 10), and the re-run resumes from it onto the uninterrupted
    fit within 1e-6 relative L2, the JAX test's bound."""
    key, x, y, spec, jl = _fit_problem()
    lsh = lsh_from_reference(jl, "cpu")
    kw = dict(lam=0.5, maxiter=40, tol=1e-10, device="cpu")
    ckdir = str(tmp_path / "solve_ck")
    with killed_checkpoint_writer(after_saves=2):
        with pytest.raises(FaultInjected):
            T.wlsh_krr_fit(lsh, x, y, SPEC, solve_checkpoint_dir=ckdir,
                           solve_checkpoint_every=5, **kw)
    assert latest_step(ckdir) == 10
    clean = T.wlsh_krr_fit(lsh, x, y, SPEC, **kw)
    resumed = T.wlsh_krr_fit(lsh, x, y, SPEC,
                             solve_checkpoint_dir=ckdir,
                             solve_checkpoint_every=5, **kw)
    rel = float(torch.linalg.norm(resumed.beta - clean.beta)
                / torch.linalg.norm(clean.beta))
    assert rel <= 1e-6


def test_overflow_policy_rejects_unknown():
    """An overflow policy neither package knows is a ValueError in both."""
    with pytest.raises(ValueError, match="overflow"):
        JD.check_step_stats(JD.StepStats(overflow_dropped=np.int32(0),
                                         wire_nonfinite=np.int32(0)),
                            overflow="panic")
    with pytest.raises(ValueError, match="overflow"):
        D.check_step_stats(D.StepStats(overflow_dropped=torch.tensor(0),
                                       wire_nonfinite=torch.tensor(0)),
                           overflow="panic")


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


def _hj_setup():
    """``test_faults._hj_setup``'s inputs, as numpy."""
    key = jax.random.PRNGKey(6)
    x = jax.random.uniform(key, (192, 3)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (192,))
    jl = jsample(jax.random.fold_in(key, 2), 4, 3, JGamma(2.0, 1.0))
    return np.asarray(x), np.asarray(y), jl


def test_stalled_shard_holds_up_the_step_wall_clock(mesh):
    """A 0.4 s stall of data rank 0 on a one-rank gloo group: the port's
    hash-join step (f32 wire, ``test_faults``' config and inputs) takes at
    least the stall, and its result is bitwise the unstalled step's."""
    x, y, jl = _hj_setup()
    kw = dict(m=4, table_size=512, lam=0.5, cg_iters=15)
    lsh = lsh_from_reference(jl, "cpu")
    plain = D.make_krr_step_hashjoin(mesh, D.KRRStepConfig(**kw), T.RECT,
                                     payload_dtype=torch.float32)
    stalled = D.make_krr_step_hashjoin(
        mesh, D.KRRStepConfig(**kw, fault_plan=FaultPlan(stall_shard=0,
                                                         stall_s=0.4)),
        T.RECT, payload_dtype=torch.float32)
    want = plain(x, y, lsh)
    t0 = time.perf_counter()
    got = stalled(x, y, lsh)
    assert time.perf_counter() - t0 >= 0.4
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
