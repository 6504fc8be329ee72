"""Port featurization (repro_torch) against the JAX package: keys, slot and
sign bitwise, weights to atol 2e-6, on the CPU's plain path.  The inputs
are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket_fns as jbf
from repro.core import lsh as jlsh
from repro.kernels.featurize import featurize_op as jax_featurize_op
from repro_torch.core import bucket_fns as tbf
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.featurize import featurize_cuda, featurize_op


def _inputs(seed, n, d, m):
    """Points and instances with large |h| (rows 0-7, and w = 1e-4 on the
    last instance, past the int32 range), half-integer t (w = 1, z = 0 on
    instance 0) and multipliers near 2^32."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d), dtype=np.float32) * 4.0 - 2.0)
    x[:8] *= np.float32(1e6)
    x[8:16] = (np.arange(8, dtype=np.float32) - 3.5)[:, None]
    w = rng.gamma(2.0, 1.0, (m, d)).astype(np.float32)
    z = (rng.random((m, d)) * w).astype(np.float32)
    w[0, :2], z[0, :2] = 1.0, 0.0
    w[-1, -1] = 1e-4
    r1 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r2 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r1[:, 0] = r2[:, 0] = np.uint32(2 ** 32 - 1)
    return x, w, z, r1, r2


def _both(x, w, z, r1, r2, fname, table_size):
    jp = jlsh.LSHParams(w=jnp.asarray(w), z=jnp.asarray(z),
                        r1=jnp.asarray(r1), r2=jnp.asarray(r2))
    want = jlsh.featurize(jp, jbf.get_bucket_fn(fname), jnp.asarray(x))
    want_slot = jlsh.slots_from_features(want, table_size)
    tp = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    got = featurize_op(tp, tbf.get_bucket_fn(fname), x,
                       table_size=table_size)
    return got, want, want_slot


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
@pytest.mark.parametrize("n,d,m", [(64, 3, 2), (200, 11, 3), (40, 64, 2)])
def test_featurize_matches_jax(fname, n, d, m):
    x, w, z, r1, r2 = _inputs(n + d + m, n, d, m)
    got, want, want_slot = _both(x, w, z, r1, r2, fname, 1 << 12)
    assert got.key1.dtype == torch.uint32 and got.slot.dtype == torch.int32
    np.testing.assert_array_equal(got.key1.numpy(), np.asarray(want.key1))
    np.testing.assert_array_equal(got.key2.numpy(), np.asarray(want.key2))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want_slot))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.coeff.numpy(),
                               np.asarray(want.weight * want.sign),
                               atol=2e-6, rtol=0)


def test_featurize_matches_pallas_kernel_interpret():
    """The same inputs through the TPU kernel in interpret mode."""
    x, w, z, r1, r2 = _inputs(7, 130, 5, 2)
    jp = jlsh.LSHParams(w=jnp.asarray(w), z=jnp.asarray(z),
                        r1=jnp.asarray(r1), r2=jnp.asarray(r2))
    want = jax_featurize_op(jp, jbf.get_bucket_fn("tent"), jnp.asarray(x),
                            interpret=True)
    got = featurize_op(tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu"),
                       tbf.get_bucket_fn("tent"), x)
    assert got.slot is None and got.coeff is None
    np.testing.assert_array_equal(got.key1.numpy(), np.asarray(want.key1))
    np.testing.assert_array_equal(got.key2.numpy(), np.asarray(want.key2))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
def test_bucket_fns_match_jax(fname):
    u = np.linspace(-0.8, 0.8, 1601).astype(np.float32)
    want = np.asarray(jbf.get_bucket_fn(fname)(jnp.asarray(u)))
    got = tbf.get_bucket_fn(fname)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tbf.get_bucket_fn(fname).acorr_y,
                                  jbf.get_bucket_fn(fname).acorr_y)


def test_sample_lsh_params_contract():
    p = tlsh.sample_lsh_params(np.random.default_rng(0), 16, 5,
                               tlsh.GammaPDF(2.0, 1.0), lengthscale=3.0)
    assert p.w.dtype == torch.float32 and p.r1.dtype == torch.uint32
    assert bool((p.w > 0).all()) and bool((p.z >= 0).all())
    assert bool((p.z <= p.w).all())
    assert bool(((p.r1.to(torch.int64) & 1) == 1).all())
    assert bool(((p.r2.to(torch.int64) & 1) == 1).all())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never takes the plain path: a CPU tensor raises."""
    x, w, z, r1, r2 = _inputs(1, 16, 3, 1)
    p = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        featurize_cuda(torch.from_numpy(x), *p,
                       f=tbf.get_bucket_fn("rect"), table_size=64)


def test_table_size_must_be_power_of_two():
    x, w, z, r1, r2 = _inputs(2, 16, 3, 1)
    p = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    with pytest.raises(ValueError, match="power of 2"):
        featurize_op(p, tbf.get_bucket_fn("rect"), x, table_size=100)
