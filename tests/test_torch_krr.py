"""Port solver stack (pcg_solve, preconditioners, wlsh_krr_fit/predict,
exact baseline, convert.py) against the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (GammaPDF as JGamma, WLSHKernelSpec as JSpec,
                        get_bucket_fn as jget, laplace_kernel as jlaplace,
                        sample_lsh_params as jsample)
from repro.core import krr as jkrr
from repro.core import precond as jpre
from repro_torch import core as T
from repro_torch.convert import lsh_from_reference, model_from_reference
from repro_torch.errors import NonFiniteError


def _spd(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    return (a @ a.T).astype(np.float32), rng


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_pcg_solve_matches_jax(k, precond):
    a, rng = _spd(k, 60)
    b = rng.standard_normal((60,) if k == 0 else (60, k)).astype(np.float32)
    diag = np.diag(a).copy()
    jp = jpre.make_preconditioner(precond, diag=jnp.asarray(diag), lam=0.3)
    tp = T.make_preconditioner(precond, diag=torch.from_numpy(diag), lam=0.3)
    want = jkrr.pcg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), 0.3,
                          precond=jp, tol=1e-6, maxiter=100)
    ta = torch.from_numpy(a)
    got = T.pcg_solve(lambda v: ta @ v, torch.from_numpy(b), 0.3,
                      precond=tp, tol=1e-6, maxiter=100)
    # matmul sums run in another order: iterates agree to float rounding
    # amplified by the conditioning, the stopping iteration to within one
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)
    assert np.abs(got.col_iters.numpy()
                  - np.asarray(want.col_iters)).max() <= 1
    hist = got.resnorm_history.numpy()
    head = hist[:, 0] > 1e-3 * hist[0, 0]
    np.testing.assert_allclose(hist[head], np.asarray(
        want.resnorm_history)[head], rtol=1e-3)


def test_pcg_deflation_sentinel_and_chunks():
    """A zero column converges at once; a poisoned column deactivates with
    resnorm NaN while the others converge; chunked checkpoints land every
    ``checkpoint_every`` iterations and end on the same iterate."""
    a, rng = _spd(7, 40)
    ta = torch.from_numpy(a)
    b = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    b[:, 1] = 0.0

    def poisoned(v):
        out = ta @ v
        out[:, 2] = float("nan")
        return out

    res = T.pcg_solve(poisoned, b, 0.5, tol=1e-6, maxiter=80)
    assert int(res.col_iters[1]) == 0 and torch.isnan(res.resnorm[2])
    assert bool(torch.isfinite(res.x).all())
    seen = []
    whole = T.pcg_solve(lambda v: ta @ v, b[:, 0], 0.5, tol=1e-7, maxiter=80)
    chunked = T.pcg_solve(lambda v: ta @ v, b[:, 0], 0.5, tol=1e-7,
                          maxiter=80, checkpoint_every=4,
                          on_checkpoint=seen.append)
    assert [st.it for st in seen[:2]] == [4, 8]
    assert seen[-1].it == chunked.iters
    assert torch.equal(chunked.x, whole.x)
    # resuming from the state saved after 8 iterations lands on the same x
    resumed = T.pcg_solve(lambda v: ta @ v, b[:, 0], 0.5, tol=1e-7,
                          maxiter=80, state=seen[1])
    assert resumed.iters == whole.iters
    assert torch.equal(resumed.x, whole.x)


def test_fit_solve_checkpoints_in_memory():
    rng = np.random.default_rng(3)
    x = rng.random((120, 2), dtype=np.float32)
    y = rng.standard_normal(120).astype(np.float32)
    lsh = T.sample_lsh_params(rng, 8, 2, T.GammaPDF(), device="cpu")
    spec = T.WLSHKernelSpec(bucket=T.RECT)
    states = []
    got = T.wlsh_krr_fit(lsh, x, y, spec, lam=0.5, device="cpu",
                         solve_checkpoint_every=3,
                         on_solve_checkpoint=states.append)
    want = T.wlsh_krr_fit(lsh, x, y, spec, lam=0.5, device="cpu")
    assert [st.it for st in states[:2]] == [3, 6]
    assert torch.equal(got.beta, want.beta)


def _op_pair(seed, n=300, d=3, m=16, lengthscale=1.0):
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.uniform(key, (n, d)) * 2.0)
    jl = jsample(jax.random.fold_in(key, 1), m, d, JGamma(2.0, 1.0),
                 lengthscale=lengthscale)
    return x, jl, lsh_from_reference(jl, "cpu")


def test_jacobi_and_nystrom_apply_match_jax():
    """Same operator in both packages: diag bitwise-close, Nyström pivots
    equal (ties to the lower index, as top_k), and P^-1 r equal."""
    from repro.core import make_operator as jmake
    x, jl, tl = _op_pair(3, lengthscale=4.0)
    jop = jmake(jl, jget("rect"), 1024, backend="reference")
    jidx = jop.build_index(jop.featurize(jnp.asarray(x)))
    top = T.make_operator(tl, T.RECT, 1024, device="cpu")
    tidx = top.build_index(top.featurize(x))
    jd, td = jpre.table_diag(jidx.coeff), T.table_diag(tidx.coeff)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    jf = jpre.nystrom_factors(lambda v: jop.matvec(jidx, v), jd, 0.1, 24)
    tf = T.nystrom_factors(lambda v: top.matvec(tidx, v), td, 0.1, 24)
    np.testing.assert_array_equal(tf.pivots.numpy(), np.asarray(jf.pivots))
    r = np.random.default_rng(0).standard_normal((300, 2)).astype(np.float32)
    for name in ("jacobi", "nystrom"):
        jp = jpre.make_preconditioner(name, diag=jd, lam=0.1, rank=24,
                                      matvec=lambda v: jop.matvec(jidx, v))
        tp = T.make_preconditioner(name, diag=td, lam=0.1, rank=24,
                                   matvec=lambda v: top.matvec(tidx, v))
        want = np.asarray(jp.apply(jnp.asarray(r)))
        got = tp.apply(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_nystrom_pivots_break_ties_to_lower_index():
    diag = torch.ones(8)
    fac = T.nystrom_factors(lambda v: v.clone(), diag, 0.5, 3)
    assert fac.pivots.tolist() == [0, 1, 2]


@pytest.mark.parametrize("precond", ["none", "jacobi", "nystrom"])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_wlsh_krr_fit_predict_match_jax(precond, backend):
    """The settings of the JAX package's backend-parity test: both fits get
    the same LSHParams and converge to tol 1e-7; predictions within 1e-5."""
    key = jax.random.PRNGKey(0)
    n, d = 300, 3
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    xq = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (77, d))
                    * 2.0)
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y,
                           JSpec(bucket=jget("rect")), m=24, lam=0.5,
                           maxiter=200, tol=1e-7, backend=backend,
                           precond=precond, precond_rank=32)
    want = np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(xq)))
    tm = T.wlsh_krr_fit(lsh_from_reference(jm.lsh, "cpu"), np.asarray(x),
                        np.asarray(y), T.WLSHKernelSpec(bucket=T.RECT),
                        lam=0.5, maxiter=200, tol=1e-7, precond=precond,
                        precond_rank=32, device="cpu")
    np.testing.assert_allclose(T.wlsh_krr_predict(tm, xq).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(
        T.wlsh_krr_predict(tm, xq, batch_size=20).numpy(), want, atol=1e-5)
    tel = tm.telemetry
    assert tel["iters"] == tel["resnorm_history"].shape[0] - 1
    assert set(tel["phase_seconds"]) == {"featurize", "layout", "pcg",
                                         "tables"}


def test_multi_rhs_fit_matches_jax():
    key = jax.random.PRNGKey(4)
    n, d, k = 200, 2, 3
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (n, k))
    xq = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (40, d))
                    * 2.0)
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y,
                           JSpec(bucket=jget("smooth"), pdf=JGamma(7.0, 1.0)),
                           m=16, lam=0.5, maxiter=300, tol=1e-7,
                           backend="reference", precond="jacobi")
    tm = T.wlsh_krr_fit(lsh_from_reference(jm.lsh, "cpu"), np.asarray(x),
                        np.asarray(y), T.WLSHKernelSpec(bucket=T.SMOOTH),
                        lam=0.5, maxiter=300, tol=1e-7, precond="jacobi",
                        device="cpu")
    assert tuple(tm.tables.shape) == (16, jm.table_size, k)
    np.testing.assert_allclose(
        T.wlsh_krr_predict(tm, xq).numpy(),
        np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(xq))), atol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_converted_jax_model_predicts_through_port(backend):
    key = jax.random.PRNGKey(9)
    x = jax.random.uniform(key, (256, 4)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (256,))
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y,
                           JSpec(bucket=jget("tent")), m=12, lam=0.5,
                           backend=backend)
    xq = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (50, 4))
                    * 2.0)
    tm = model_from_reference(jm, "cpu")
    assert tm.table_size == jm.table_size and tm.bucket_name == "tent"
    np.testing.assert_allclose(
        T.wlsh_krr_predict(tm, xq, batch_size=16).numpy(),
        np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(xq))), atol=1e-5)


def test_convert_rejects_signed_multipliers():
    _, jl, _ = _op_pair(1)
    bad = jl._replace(r1=np.asarray(jl.r1).astype(np.int64))
    with pytest.raises(ValueError, match="uint32"):
        lsh_from_reference(bad, "cpu")


def test_exact_krr_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((80, 3), dtype=np.float32)
    y = rng.standard_normal(80).astype(np.float32)
    xq = rng.random((10, 3), dtype=np.float32)
    jb = jkrr.exact_krr_fit(jlaplace, jnp.asarray(x), jnp.asarray(y), 0.1)
    want = jkrr.exact_krr_predict(jlaplace, jnp.asarray(x), jb,
                                  jnp.asarray(xq))
    tx = torch.from_numpy(x)
    tb = T.exact_krr_fit(T.laplace_kernel, tx, torch.from_numpy(y), 0.1)
    got = T.exact_krr_predict(T.laplace_kernel, tx, tb, torch.from_numpy(xq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_fit_rejects_non_finite_targets():
    _, _, tl = _op_pair(2)
    x = np.random.default_rng(0).random((50, 3), dtype=np.float32)
    y = np.zeros(50, np.float32)
    y[3] = np.nan
    with pytest.raises(NonFiniteError) as err:
        T.wlsh_krr_fit(tl, x, y, T.WLSHKernelSpec(bucket=T.RECT), lam=0.5,
                       device="cpu")
    assert err.value.where == "y" and err.value.count == 1
    model = T.wlsh_krr_fit(tl, x, np.stack([y, np.ones(50, np.float32)], 1),
                           T.WLSHKernelSpec(bucket=T.RECT), lam=0.5,
                           device="cpu", nonfinite_targets="deactivate")
    assert np.isnan(model.telemetry["resnorm_history"][-1, 0])
    assert bool(torch.isfinite(model.beta).all())
