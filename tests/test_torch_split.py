"""The split (loads -> readout) path of the port against the JAX package on
the CPU: the plain versions of B5 and B6 against the Pallas kernels in
interpret mode, the layout at the split geometry bitwise, the operator's
split matvec and ``wlsh_krr_fit(fused=False)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (GammaPDF as JGamma, WLSHKernelSpec as JSpec,
                        get_bucket_fn as jget, make_operator as jmake,
                        sample_lsh_params as jsample)
from repro.core import krr as jkrr
from repro.core.wlsh import build_blocked_layout as j_layout
from repro.kernels.binning import (bin_gather_blocked_pallas,
                                   bin_scatter_pallas)
from repro_torch import core as T
from repro_torch.convert import lsh_from_reference
from repro_torch.core.wlsh import BLOCKED_SPLIT_N, BLOCKED_SPLIT_T
from repro_torch.kernels.binning import gather_blocked_ref, scatter_ref


def _slots(m, n, table_size, seed):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, table_size, (m, n)).astype(np.int32)
    slot[:, : n // 8] = 3                       # a heavy bucket
    return slot, rng


@pytest.mark.parametrize("k", [None, 4])
def test_scatter_plain_matches_pallas(k):
    """B5's plain version against ``bin_scatter_pallas`` (the TPU's
    one-hot cross product; the JAX package runs k columns one call each).
    The one-hot product sums a slot's points in another association: equal
    to 1e-6 of the largest load."""
    m, n, table_size = 3, 256, 1024
    slot, rng = _slots(m, n, table_size, 1)
    contrib = rng.standard_normal((m, n) if k is None else (m, n, k)
                                  ).astype(np.float32)
    cols = [contrib] if k is None else [contrib[..., j] for j in range(k)]
    want = np.stack([np.asarray(bin_scatter_pallas(
        jnp.asarray(slot), jnp.asarray(c), table_size=table_size,
        block_n=128, interpret=True)) for c in cols], -1)
    want = want[..., 0] if k is None else want
    got = scatter_ref(torch.from_numpy(slot), torch.from_numpy(contrib),
                      table_size=table_size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k", [None, 3])
def test_gather_blocked_plain_matches_pallas(k):
    """B6's plain version against ``bin_gather_blocked_pallas`` over a
    split-geometry layout, bitwise at every point's layout position; the
    port keeps its (m, B, k) table order, the Pallas kernel reads
    (m, k, B).  Padding positions (slot 0) read slot 0 on the card and 0
    off-tile on the TPU; no point maps back to them."""
    m, n, table_size = 3, 300, 1000
    slot, rng = _slots(m, n, table_size, 2)
    lay = j_layout(jnp.asarray(slot), jnp.ones((m, n)), table_size,
                   block_n=BLOCKED_SPLIT_N, block_t=BLOCKED_SPLIT_T,
                   parts="pallas")
    width = lay.num_tiles * lay.block_t
    tables = rng.standard_normal((m, table_size) if k is None
                                 else (m, table_size, k)).astype(np.float32)
    pad = ((0, 0), (0, width - table_size)) + ((0, 0),) * (tables.ndim - 2)
    t_pallas = np.pad(tables, pad)
    if k is not None:
        t_pallas = np.swapaxes(t_pallas, 1, 2)
    want = np.asarray(bin_gather_blocked_pallas(
        lay.vg_tile, lay.slot_lay, jnp.asarray(t_pallas),
        block_n=lay.block_n, block_t=lay.block_t, interpret=True))
    if k is not None:
        want = np.swapaxes(want, 1, 2)                     # (m, L, k)
    got = gather_blocked_ref(torch.from_numpy(np.array(lay.slot_lay)),
                             torch.from_numpy(tables)).numpy()
    rows = np.arange(m)[:, None]
    inv = np.asarray(lay.inv_pos)
    np.testing.assert_array_equal(got[rows, inv], want[rows, inv])


def _problem(n=257, d=3, m=5, seed=0):
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.uniform(key, (n, d)) * 2.0)
    beta = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (n, 4)))
    jl = jsample(jax.random.fold_in(key, 2), m, d, JGamma(2.0, 1.0))
    return x, beta, jl, lsh_from_reference(jl, "cpu")


def test_split_geometry_layout_is_bitwise():
    """An index of an unfused operator carries the layout at the split
    geometry (block_n = 64), both groups bitwise as the JAX package's."""
    x, _, jl, tl = _problem()
    jop = jmake(jl, jget("rect"), 1024, backend="pallas", fused=False)
    jidx = jop.build_index(jop.featurize(jnp.asarray(x)), blocked=True,
                           parts="both")
    top = T.make_operator(tl, T.RECT, 1024, device="cpu", fused=False)
    tidx = top.build_index(top.featurize(x), blocked=True, parts="both")
    assert tidx.blocked.block_n == BLOCKED_SPLIT_N == jidx.blocked.block_n
    for name in ("perm", "seg_id", "seg_pt", "coeff_sorted", "inv_pos",
                 "src", "slot_lay", "coeff_lay", "v_block", "v_tile",
                 "v_phase", "vs_block", "vs_tile", "vg_tile", "n_visits"):
        np.testing.assert_array_equal(
            getattr(tidx.blocked, name).numpy(),
            np.asarray(getattr(jidx.blocked, name)), err_msg=name)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("k", [0, 4])
def test_split_matvec_loads_readout_match_jax(blocked, k):
    """``op.matvec`` of an unfused operator (loads then readout: B3 + B6
    off the layout, B5 + B4 without it), ``op.loads`` and ``op.readout``
    against the JAX package's split path, to 1e-5 of max|out|."""
    x, beta, jl, tl = _problem()
    beta = beta[:, 0] if k == 0 else beta
    jop = jmake(jl, jget("rect"), 1024, backend="reference", fused=False)
    jidx = jop.build_index(jop.featurize(jnp.asarray(x)), blocked=False)
    top = T.make_operator(tl, T.RECT, 1024, device="cpu", fused=False)
    tidx = top.build_index(top.featurize(x), blocked=blocked)
    assert (tidx.blocked is not None) == blocked
    tb = torch.from_numpy(np.array(beta))
    want_t = np.asarray(jop.loads(jidx, jnp.asarray(beta)))
    got_t = top.loads(tidx, tb)
    np.testing.assert_allclose(got_t.numpy(), want_t,
                               atol=1e-5 * np.abs(want_t).max())
    for average in (True, False):
        want = np.asarray(jop.readout(jidx, jnp.asarray(want_t),
                                      average=average))
        got = top.readout(tidx, torch.from_numpy(want_t), average=average)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-6 * np.abs(want).max())
        want = np.asarray(jop.matvec(jidx, jnp.asarray(beta),
                                     average=average))
        got = top.matvec(tidx, tb, average=average)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("k", [0, 3])
def test_fit_unfused_matches_jax(k):
    """``wlsh_krr_fit(fused=False)`` (no layout; B5 + B4 every iteration)
    against the JAX package's unfused fit: betas within 1e-5 of max|beta|,
    and the same model as the port's fused fit."""
    key = jax.random.PRNGKey(3)
    n, d = 300, 3
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1), (n,) if k == 0
                          else (n, k))
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y,
                           JSpec(bucket=jget("rect")), m=16, lam=0.5,
                           maxiter=200, tol=1e-7, backend="reference",
                           fused=False)
    kw = dict(lam=0.5, maxiter=200, tol=1e-7, device="cpu")
    tl = lsh_from_reference(jm.lsh, "cpu")
    tm = T.wlsh_krr_fit(tl, np.asarray(x), np.asarray(y),
                        T.WLSHKernelSpec(bucket=T.RECT), fused=False, **kw)
    want = np.asarray(jm.beta)
    np.testing.assert_allclose(tm.beta.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tm.tables.numpy(), np.asarray(jm.tables),
                               atol=1e-5 * np.abs(np.asarray(jm.tables)).max())
    fused = T.wlsh_krr_fit(tl, np.asarray(x), np.asarray(y),
                           T.WLSHKernelSpec(bucket=T.RECT), **kw)
    np.testing.assert_allclose(tm.beta.numpy(), fused.beta.numpy(),
                               atol=1e-5 * np.abs(want).max())
