"""The port's estimator pieces against the JAX package on the CPU: the
kernel functions and the analytic WLSH kernel, exact mode (the sorted-bucket
index and its matvec), the table matvec, cg_solve and pcg_solve's warm
start, and wlsh_krr_fit in exact mode; then the JAX package's own
properties of these pieces, run at the port."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.core import krr as jkrr
from repro.core import wlsh as jw
from repro.core import (GammaPDF as JGamma, get_bucket_fn as jget,
                        sample_lsh_params as jsample)
from repro.core.lsh import Features as JFeatures
from repro_torch import core as T
from repro_torch.convert import lsh_from_reference
from repro_torch.core.gp import gp_regression_dataset

PDFS = {"gamma2": (2.0, 1.0), "gamma7": (7.0, 1.0)}


def _points(seed, n, d, scale=2.0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) * scale).astype(np.float32)
    return x, rng


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# kernel functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ell", [0.7, 2.5])
@pytest.mark.parametrize("name", ["laplace", "gaussian", "matern52"])
def test_kernel_functions_match_jax(name, ell):
    x, _ = _points(1, 70, 5)
    y, _ = _points(2, 45, 5)
    y[:3] = x[:3]                               # zero distances
    y[3] = x[3] + np.float32(1e-4)              # one tiny distance
    want = jk.KERNELS[name](jnp.asarray(x), jnp.asarray(y), lengthscale=ell)
    got = T.KERNELS[name](torch.from_numpy(x), torch.from_numpy(y),
                          lengthscale=ell)
    _close(got.numpy(), want, 1e-6)


def test_kernel_row_blocks_give_the_same_values(monkeypatch):
    """A block budget of a few rows gives the unblocked values bitwise."""
    x, _ = _points(3, 37, 6)
    tx = torch.from_numpy(x)
    whole = {k: f(tx, tx, 1.3) for k, f in T.KERNELS.items()}
    kern = T.make_wlsh_kernel(T.WLSHKernelSpec(bucket=T.TENT,
                                               lengthscale=1.3))
    whole["wlsh"] = kern(tx, tx)
    monkeypatch.setattr(T.kernels, "PAIRWISE_BLOCK_ELEMS", 5 * 37 * 6)
    for k, f in T.KERNELS.items():
        assert torch.equal(f(tx, tx, 1.3), whole[k]), k
    assert torch.equal(kern(tx, tx), whole["wlsh"])


@functools.lru_cache(maxsize=None)
def _tables(bucket, pdf):
    spec_j = jk.WLSHKernelSpec(bucket=jget(bucket), pdf=JGamma(*PDFS[pdf]))
    spec_t = T.WLSHKernelSpec(bucket=T.get_bucket_fn(bucket),
                              pdf=T.GammaPDF(*PDFS[pdf]))
    return jk.tabulate_wlsh_k1d(spec_j), T.tabulate_wlsh_k1d(spec_t)


@pytest.mark.parametrize("pdf", sorted(PDFS))
@pytest.mark.parametrize("bucket", ["rect", "tent", "smooth"])
def test_tabulate_wlsh_k1d_bitwise(bucket, pdf):
    (jx, jy), (tx, ty) = _tables(bucket, pdf)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("bucket,pdf,ell", [("rect", "gamma2", 1.0),
                                            ("tent", "gamma2", 0.5),
                                            ("smooth", "gamma7", 2.0)])
def test_wlsh_kernel_matches_jax(bucket, pdf, ell):
    (jx, jy), (tx, ty) = _tables(bucket, pdf)
    jkern = jk.WLSHKernel(spec=jk.WLSHKernelSpec(
        bucket=jget(bucket), pdf=JGamma(*PDFS[pdf]), lengthscale=ell),
        table_x=jx, table_y=jy)
    tkern = T.WLSHKernel(spec=T.WLSHKernelSpec(
        bucket=T.get_bucket_fn(bucket), pdf=T.GammaPDF(*PDFS[pdf]),
        lengthscale=ell), table_x=tx, table_y=ty)
    x, _ = _points(4, 50, 3, scale=30.0)        # reaches past x_max = 40
    y, _ = _points(5, 40, 3, scale=30.0)
    y[:2] = x[:2]
    _close(tkern(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
           jkern(jnp.asarray(x), jnp.asarray(y)), 1e-6)
    t = np.concatenate([np.linspace(-45.0, 45.0, 301, dtype=np.float32),
                        tx[:5].astype(np.float32), [np.float32(tx[-1])]])
    _close(tkern.k1d(torch.from_numpy(t)).numpy(), jkern.k1d(jnp.asarray(t)),
           1e-6)


# ---------------------------------------------------------------------------
# exact mode
# ---------------------------------------------------------------------------

def _keys(case, m, n, rng):
    if case == "full range":
        hi = 2 ** 32
    elif case == "few values":                  # many duplicated keys
        hi = 3
    else:                                       # key1 >= 2^31 throughout
        hi = 2 ** 32
    key1 = rng.integers(0, hi, (m, n), dtype=np.uint64).astype(np.uint32)
    key2 = rng.integers(0, hi, (m, n), dtype=np.uint64).astype(np.uint32)
    if case == "high key1":
        key1 = (key1 % 4) | np.uint32(2 ** 31)
        key1[:, ::5] = np.uint32(2 ** 32 - 1)
        key2[:, ::3] = np.uint32(0)
    key1[:, 1] = key1[:, 0]                     # an exact duplicate pair
    key2[:, 1] = key2[:, 0]
    return key1, key2


def _features(key1, key2, weight):
    m, n = key1.shape
    sign = np.ones((m, n), np.float32)
    jf = JFeatures(key1=jnp.asarray(key1), key2=jnp.asarray(key2),
                   weight=jnp.asarray(weight), sign=jnp.asarray(sign))
    tf = T.Features(key1=torch.from_numpy(key1), key2=torch.from_numpy(key2),
                    weight=torch.from_numpy(weight),
                    sign=torch.from_numpy(sign))
    return jf, tf


@pytest.mark.parametrize("case", ["full range", "few values", "high key1"])
def test_build_exact_index_bitwise(case):
    rng = np.random.default_rng(len(case))
    key1, key2 = _keys(case, 4, 301, rng)
    weight = rng.standard_normal((4, 301)).astype(np.float32)
    jf, tf = _features(key1, key2, weight)
    j, t = jw.build_exact_index(jf), T.build_exact_index(tf)
    for name in ("perm", "seg_id"):
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert torch.equal(t.weight, tf.weight)


def _exact_pair(seed, n, d, m, bucket="rect", pdf=(2.0, 1.0)):
    key = jax.random.PRNGKey(seed)
    x = np.array(jax.random.uniform(key, (n, d)) * 2.0)
    jl = jsample(jax.random.fold_in(key, 1), m, d, JGamma(*pdf))
    jf = jw.featurize(jl, jget(bucket), jnp.asarray(x))
    tl = lsh_from_reference(jl, "cpu")
    tf = T.featurize(tl, T.get_bucket_fn(bucket), torch.from_numpy(x))
    return jf, tf


@pytest.mark.parametrize("k", [1, 4])
def test_exact_matvec_and_kernel_matrix_match_jax(k):
    jf, tf = _exact_pair(11, 120, 2, 9, bucket="tent")
    beta = np.random.default_rng(k).standard_normal(
        (120,) if k == 1 else (120, k)).astype(np.float32)
    want = jw.exact_matvec(jw.build_exact_index(jf), jnp.asarray(beta))
    got = T.exact_matvec(T.build_exact_index(tf), torch.from_numpy(beta))
    assert tuple(got.shape) == beta.shape
    _close(got.numpy(), want, 1e-5)
    _close(T.exact_kernel_matrix(tf).numpy(), jw.exact_kernel_matrix(jf),
           1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_table_matvec_and_kernel_matrix_match_jax(k):
    jf, tf = _exact_pair(12, 150, 3, 8, bucket="smooth", pdf=(7.0, 1.0))
    jidx, tidx = jw.build_table_index(jf, 256), T.build_table_index(tf, 256)
    beta = np.random.default_rng(k).standard_normal(
        (150,) if k == 1 else (150, k)).astype(np.float32)
    _close(T.table_matvec(tidx, torch.from_numpy(beta)).numpy(),
           jw.table_matvec(jidx, jnp.asarray(beta)), 1e-5)
    _close(T.table_kernel_matrix(tidx).numpy(),
           jw.table_kernel_matrix(jidx), 1e-5)


@pytest.mark.parametrize("mode", ["exact", "table"])
def test_make_matvec_and_estimator(mode):
    jf, tf = _exact_pair(13, 90, 2, 5)
    beta = np.random.default_rng(0).standard_normal(90).astype(np.float32)
    jmv, _ = jw.make_matvec(jf, mode, table_size=128)
    tmv, tidx = T.make_matvec(tf, mode, table_size=128)
    assert isinstance(tidx, T.ExactIndex if mode == "exact" else T.TableIndex)
    _close(tmv(torch.from_numpy(beta)).numpy(), jmv(jnp.asarray(beta)), 1e-5)
    with pytest.raises(ValueError):
        T.make_matvec(tf, "table", table_size=0)
    with pytest.raises(ValueError):
        T.make_matvec(tf, "nope")
    est = T.WLSHEstimator(params=T.sample_lsh_params(
        np.random.default_rng(1), 3, 2, T.GammaPDF(), device="cpu"),
        bucket_name="rect",
        mode=mode, table_size=128)
    feats = est.featurize(T.RECT, np.zeros((4, 2), np.float32))
    assert tuple(feats.key1.shape) == (3, 4)


def test_operator_exact_mode():
    """build_index(mode='exact') gives the exact index and matvec runs it;
    the sum form and an unknown mode raise, as in the JAX operator."""
    jf, tf = _exact_pair(14, 64, 2, 6)
    op = T.make_operator(T.sample_lsh_params(np.random.default_rng(0), 6, 2,
                                             T.GammaPDF(), device="cpu"),
                         T.RECT, 256, device="cpu")
    idx = op.build_index(tf, mode="exact")
    assert isinstance(idx, T.ExactIndex)
    beta = torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                            .astype(np.float32))
    assert torch.equal(op.matvec(idx, beta), T.exact_matvec(idx, beta))
    with pytest.raises(ValueError):
        op.matvec(idx, beta, average=False)
    with pytest.raises(ValueError):
        op.build_index(tf, mode="nope")


def test_core_exports_every_name_of_the_jax_core():
    import repro.core as jcore
    ns = {}
    exec("from repro_torch.core import *", ns)
    want = {n for n in vars(jcore) if not n.startswith("_")
            and not isinstance(getattr(jcore, n), type(jcore))}
    assert sorted(want - set(ns)) == []


# ---------------------------------------------------------------------------
# solvers and the exact-mode fit
# ---------------------------------------------------------------------------

def _spd(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    return (a @ a.T).astype(np.float32), rng


def test_cg_solve_matches_jax():
    a, rng = _spd(5, 64)
    b = rng.standard_normal(64).astype(np.float32)
    want = jkrr.cg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), 0.3,
                         tol=1e-8, maxiter=300)
    ta = torch.from_numpy(a)
    got = T.cg_solve(lambda v: ta @ v, torch.from_numpy(b), 0.3, tol=1e-8,
                     maxiter=300)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)
    assert got.iters.ndim == 0 and got.resnorm.ndim == 0
    assert abs(int(got.iters) - int(want.iters)) <= 1


@pytest.mark.parametrize("k", [0, 2])
def test_pcg_warm_start_matches_jax(k):
    a, rng = _spd(6 + k, 60)
    b = rng.standard_normal((60,) if k == 0 else (60, k)).astype(np.float32)
    x0 = rng.standard_normal(b.shape).astype(np.float32)
    want = jkrr.pcg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), 0.3,
                          tol=1e-6, maxiter=100, x0=jnp.asarray(x0))
    ta = torch.from_numpy(a)
    got = T.pcg_solve(lambda v: ta @ v, torch.from_numpy(b), 0.3, tol=1e-6,
                      maxiter=100, x0=torch.from_numpy(x0))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)
    hist = got.resnorm_history.numpy()
    np.testing.assert_allclose(hist[0], np.asarray(want.resnorm_history)[0],
                               rtol=1e-5)
    # a warm start at the solution stops at once
    sol = got.x.clone()
    again = T.pcg_solve(lambda v: ta @ v, torch.from_numpy(b), 0.3,
                        tol=1e-3, maxiter=100, x0=sol)
    assert again.iters == 0 and torch.equal(again.x, sol)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_wlsh_krr_fit_exact_mode_matches_jax(precond):
    key = jax.random.PRNGKey(21)
    n, d = 250, 3
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (n,))
    xq = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (60, d))
                    * 2.0)
    spec_j = jk.WLSHKernelSpec(bucket=jget("smooth"), pdf=JGamma(7.0, 1.0),
                               lengthscale=1.5)
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y, spec_j, m=32,
                           lam=0.5, mode="exact", tol=1e-7, maxiter=300,
                           backend="reference", precond=precond)
    want = np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(xq)))
    tm = T.wlsh_krr_fit(lsh_from_reference(jm.lsh, "cpu"), np.asarray(x),
                        np.asarray(y), T.WLSHKernelSpec(
                            bucket=T.SMOOTH, pdf=T.GammaPDF(7.0, 1.0),
                            lengthscale=1.5),
                        lam=0.5, mode="exact", tol=1e-7, maxiter=300,
                        precond=precond, device="cpu")
    assert tm.table_size == jm.table_size
    _close(T.wlsh_krr_predict(tm, xq).numpy(), want, 1e-4)
    _close(tm.beta.numpy(), jm.beta, 1e-4)
    with pytest.raises(ValueError):
        T.wlsh_krr_fit(tm.lsh, np.asarray(x), np.asarray(y),
                       T.WLSHKernelSpec(bucket=T.SMOOTH), lam=0.5,
                       mode="nope", device="cpu")


# ---------------------------------------------------------------------------
# the JAX package's own properties, at the port
# ---------------------------------------------------------------------------

def test_analytic_wlsh_kernel_matches_laplace():
    """tests/test_core_wlsh.py: rect + Gamma(2, 1) is the Laplace kernel."""
    kern = T.make_wlsh_kernel(T.WLSHKernelSpec(bucket=T.RECT,
                                               pdf=T.GammaPDF(2.0, 1.0)))
    x = torch.from_numpy(_points(7, 64, 3, scale=3.0)[0])
    np.testing.assert_allclose(kern(x, x).numpy(),
                               T.laplace_kernel(x, x).numpy(), atol=2e-4)


@pytest.mark.parametrize("n,d,m", [(16, 1, 1), (33, 2, 5), (100, 4, 24),
                                   (57, 3, 11)])
def test_exact_matvec_matches_dense(n, d, m):
    """tests/test_core_wlsh.py: the sorted-bucket matvec equals the
    explicit estimator matrix times beta."""
    x, rng = _points(n * 100 + d * 10 + m, n, d)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    feats = T.featurize(lsh, T.RECT, torch.from_numpy(x))
    beta = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    dense = T.exact_kernel_matrix(feats) @ beta
    mv = T.exact_matvec(T.build_exact_index(feats), beta)
    np.testing.assert_allclose(mv.numpy(), dense.numpy(), atol=1e-4)


def test_wlsh_krr_exact_mode_close_to_exact_laplace_krr():
    """tests/test_krr.py: with many instances the exact-mode solution
    approaches exact KRR on the analytically equal Laplace kernel."""
    rng = np.random.default_rng(0)
    x, y, _ = gp_regression_dataset(rng, T.laplace_kernel, n=200, d=2,
                                    noise=0.05, device="cpu")
    lam = 1.0
    beta_exact = T.exact_krr_fit(T.laplace_kernel, x, y, lam=lam)
    pred_exact = T.exact_krr_predict(T.laplace_kernel, x, beta_exact, x)
    lsh = T.sample_lsh_params(rng, 1500, 2, T.GammaPDF(2.0, 1.0),
                              device="cpu")
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT),
                           lam=lam, mode="exact", device="cpu")
    pred_appr = T.exact_krr_predict(T.laplace_kernel, x, model.beta, x)
    err = float((pred_appr - pred_exact).abs().max())
    assert err < 0.25 * float(y.std()), err
