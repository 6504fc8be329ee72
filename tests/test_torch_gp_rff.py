"""The port's GP sampling (core/gp.py) and RFF baseline (core/rff.py)
against the JAX package on the CPU, and the JAX package's own RFF property
run at the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels as jk
from repro.core import rff as jrff
from repro_torch import core as T
from repro_torch.core import gp as tgp


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * np.abs(want).max(), rtol=0)


def _jax_rff_draws(key, d, n_features, lengthscale):
    """W and b as ``repro.core.rff.rff_krr_fit`` draws them from ``key``."""
    kw, kb = jax.random.split(key)
    w = jax.random.normal(kw, (d, n_features)) * jnp.sqrt(2.0) / lengthscale
    b = jax.random.uniform(kb, (n_features,), maxval=2.0 * jnp.pi)
    return np.array(w), np.array(b)


@pytest.mark.parametrize("n,d,n_features,ell", [(300, 3, 128, 1.0),
                                                (500, 8, 256, 2.5)])
def test_rff_from_jax_draws_matches_jax(n, d, n_features, ell):
    rng = np.random.default_rng(n)
    x = rng.random((n, d), dtype=np.float32) * 2.0
    y = rng.standard_normal(n).astype(np.float32)
    xq = rng.random((70, d), dtype=np.float32) * 2.0
    key = jax.random.PRNGKey(d)
    jm = jrff.rff_krr_fit(key, jnp.asarray(x), jnp.asarray(y),
                          n_features=n_features, lam=0.5, lengthscale=ell)
    w, b = _jax_rff_draws(key, d, n_features, ell)
    np.testing.assert_array_equal(w, np.asarray(jm.w))
    np.testing.assert_array_equal(b, np.asarray(jm.b))
    tm = T.rff_krr_solve(torch.from_numpy(w), torch.from_numpy(b), x, y,
                         lam=0.5)
    _close(T.rff_krr_predict(tm, xq).numpy(),
           jrff.rff_krr_predict(jm, jnp.asarray(xq)), 1e-4)
    _close(T.rff_features(tm.w, tm.b, torch.from_numpy(xq)).numpy(),
           jrff.rff_features(jm.w, jm.b, jnp.asarray(xq)), 1e-5)


def test_rff_draw_statistics_and_device():
    """W ~ N(0, 2 / ell^2), b ~ U[0, 2 pi], from the generator; the fit's
    default device is the card (it raises without one)."""
    w, b = T.rff_draw(np.random.default_rng(0), 4, 20000, lengthscale=2.0,
                      device="cpu")
    assert w.dtype == b.dtype == torch.float32
    assert abs(float(w.var()) - 0.5) < 0.02
    assert 0.0 <= float(b.min()) and float(b.max()) <= 2.0 * np.pi
    w2, _ = T.rff_draw(np.random.default_rng(0), 4, 20000, lengthscale=2.0,
                      device="cpu")
    assert torch.equal(w, w2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            T.rff_krr_fit(np.random.default_rng(0), np.zeros((4, 2)),
                          np.zeros(4), n_features=8, lam=1.0)


def test_rff_krr_fits_gaussian_gp():
    """tests/test_krr.py: RFF learns a squared-exponential GP."""
    rng = np.random.default_rng(0)
    x, y, f = tgp.gp_regression_dataset(rng, T.gaussian_kernel, n=400, d=2,
                                        noise=0.05, device="cpu")
    model = T.rff_krr_fit(rng, x, y, n_features=512, lam=0.05, device="cpu")
    pred = T.rff_krr_predict(model, x)
    rmse = float(torch.sqrt(((pred - f) ** 2).mean()))
    assert rmse < 0.15, rmse


@pytest.mark.parametrize("name", ["laplace", "gaussian", "matern52"])
def test_gp_root_matches_jax(name):
    """R R^T of the port's eigh root against the JAX package's (the
    eigenvectors' signs differ, their products do not)."""
    x = np.random.default_rng(3).random((80, 3), dtype=np.float32)
    kern_t = lambda a, b: T.KERNELS[name](a, b, lengthscale=0.8)
    kern_j = lambda a, b: jk.KERNELS[name](a, b, lengthscale=0.8)
    k = kern_j(jnp.asarray(x), jnp.asarray(x)).astype(jnp.float32)
    evals, evecs = jnp.linalg.eigh(k)
    want = evecs * jnp.sqrt(jnp.maximum(evals, 1e-6))[None, :]
    got = tgp.kernel_root(torch.from_numpy(x), kern_t, 1e-6)
    assert got.dtype == torch.float32
    _close((got @ got.T).numpy(), want @ want.T, 1e-4)
    np.testing.assert_allclose((got @ got.T).numpy(), np.asarray(k),
                               atol=1e-4)
    assert tgp.kernel_root(torch.from_numpy(x).double(), kern_t
                           ).dtype == torch.float64


def test_gp_sample_covariance():
    """Samples of GP(0, k) at five points have covariance k."""
    x = torch.from_numpy(np.random.default_rng(4).random((5, 2),
                                                         dtype=np.float32))
    s = tgp.sample_gp_batch(np.random.default_rng(5), x, T.laplace_kernel,
                            20000)
    assert s.dtype == torch.float32 and tuple(s.shape) == (5, 20000)
    cov = (s @ s.T) / s.shape[1]
    np.testing.assert_allclose(cov.numpy(), T.laplace_kernel(x, x).numpy(),
                               atol=0.05)
    one = tgp.sample_gp(np.random.default_rng(5), x, T.laplace_kernel)
    assert tuple(one.shape) == (5,) and bool(torch.isfinite(one).all())


def test_gp_regression_dataset_and_posterior_rhs():
    rng = np.random.default_rng(6)
    x, y, f = tgp.gp_regression_dataset(rng, T.gaussian_kernel, n=90, d=3,
                                        noise=0.1, device="cpu")
    assert tuple(x.shape) == (90, 3) and tuple(y.shape) == tuple(f.shape)
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert 0.05 < float((y - f).std()) < 0.2
    rhs, f_all = tgp.gp_posterior_rhs(rng, x, y[:60], T.gaussian_kernel,
                                      n_train=60, n_samples=3, noise=0.1)
    assert tuple(rhs.shape) == (60, 4) and tuple(f_all.shape) == (90, 3)
    assert torch.equal(rhs[:, 0], y[:60])
    resid = y[:60, None] - f_all[:60] - rhs[:, 1:]
    assert 0.05 < float(resid.std()) < 0.2          # the noise draws
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tgp.gp_regression_dataset(rng, T.gaussian_kernel, n=4, d=2)


def test_gp_posterior_rhs_fit_gives_posterior_samples():
    """The RHS block through a multi-RHS exact-mode fit: column 0 is the
    posterior mean's solve, and each sample column's solve equals its own
    single-column fit."""
    rng = np.random.default_rng(7)
    x, y, _ = tgp.gp_regression_dataset(rng, T.laplace_kernel, n=120, d=2,
                                        noise=0.1, device="cpu")
    rhs, _ = tgp.gp_posterior_rhs(rng, x, y, T.laplace_kernel, n_train=120,
                                  n_samples=2, noise=0.1)
    lsh = T.sample_lsh_params(rng, 64, 2, T.GammaPDF(), device="cpu")
    spec = T.WLSHKernelSpec(bucket=T.RECT)
    block = T.wlsh_krr_fit(lsh, x, rhs, spec, lam=0.1, mode="exact",
                           tol=1e-7, device="cpu")
    for j in range(3):
        one = T.wlsh_krr_fit(lsh, x, rhs[:, j], spec, lam=0.1, mode="exact",
                             tol=1e-7, device="cpu")
        _close(block.beta[:, j].numpy(), one.beta.numpy(), 1e-4)
