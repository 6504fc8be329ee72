"""Port table mode (repro_torch.core.wlsh + kernels/binning, plain path)
against the JAX package: the slot-blocked layout bitwise, and the matvec,
table build and readout against the JAX reference ops and, at tiny n, the
Pallas kernels in interpret mode on the same layout arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wlsh as jw
from repro.kernels.binning import (bin_fused_matvec_pallas,
                                   bin_gather_pallas,
                                   bin_scatter_blocked_pallas)
from repro_torch.core import wlsh as tw
from repro_torch.kernels.binning import (bin_fused_matvec_op,
                                         bin_loads_blocked_op,
                                         bin_readout_op, fused_matvec_ref,
                                         gather_ref, scatter_blocked_ref)


def _slots(seed, m, n, table_size):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, table_size, (m, n)).astype(np.int32)
    slot[0, : n // 3] = 5                       # one heavy bucket
    coeff = rng.standard_normal((m, n)).astype(np.float32)
    coeff[:, -3:] = 0.0                         # zero weights
    return slot, coeff


def _pair(slot, coeff, table_size, **kw):
    j = jw.build_blocked_layout(jnp.asarray(slot), jnp.asarray(coeff),
                                table_size, parts="both", **kw)
    t = tw.build_blocked_layout(torch.from_numpy(slot),
                                torch.from_numpy(coeff), table_size,
                                parts="both", **kw)
    return j, t


def _indexes(slot, coeff, table_size, **kw):
    jl, tl = _pair(slot, coeff, table_size, **kw)
    ones = np.ones_like(coeff)
    jidx = jw.TableIndex(slot=jnp.asarray(slot), sign=jnp.asarray(ones),
                         weight=jnp.asarray(coeff), coeff=jnp.asarray(coeff),
                         table_size=table_size, blocked=jl)
    tidx = tw.TableIndex(slot=torch.from_numpy(slot),
                         sign=torch.from_numpy(ones),
                         weight=torch.from_numpy(coeff),
                         coeff=torch.from_numpy(coeff),
                         table_size=table_size, blocked=tl)
    return jidx, tidx


@pytest.mark.parametrize("m,n,table_size,bn,bt", [
    (3, 300, 1024, 128, 512), (2, 1000, 4096, 128, 512),
    (2, 64, 100, 16, 32), (4, 513, 2048, 64, 384), (1, 10, 1 << 14, 128, 512)])
def test_blocked_layout_bitwise(m, n, table_size, bn, bt):
    slot, coeff = _slots(m * n, m, n, table_size)
    j, t = _pair(slot, coeff, table_size, block_n=bn, block_t=bt)
    for name in j._fields:
        jv = getattr(j, name)
        if isinstance(jv, int):
            assert getattr(t, name) == jv, name
            continue
        tv = getattr(t, name)
        assert tv.dtype in (torch.int32, torch.float32), name
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=name)
        assert np.asarray(jv).dtype == tv.numpy().dtype, name


def test_blocked_layout_tile_offsets():
    """blk_start (the port's addition): tile t owns layout blocks
    [blk_start[t], blk_start[t+1]), and its slots lie inside the tile."""
    slot, coeff = _slots(3, 2, 700, 4096)
    t = tw.build_blocked_layout(torch.from_numpy(slot),
                                torch.from_numpy(coeff), 4096)
    assert t.perm is None and t.src is not None
    bn, bt = t.block_n, t.block_t
    for s in range(2):
        for tile in range(t.num_tiles):
            lo, hi = (int(v) * bn for v in t.blk_start[s, tile:tile + 2])
            seg = t.slot_lay[s, lo:hi][t.coeff_lay[s, lo:hi] != 0]
            assert bool(((seg // bt) == tile).all())
    assert bool((t.blk_start[:, -1] * 2 == t.n_visits).all())


@pytest.mark.parametrize("k", [0, 3])
def test_plain_binning_matches_jax_reference(k):
    m, n, table_size = 3, 400, 2048
    slot, coeff = _slots(k + 1, m, n, table_size)
    jidx, tidx = _indexes(slot, coeff, table_size)
    rng = np.random.default_rng(k)
    beta = rng.standard_normal((n,) if k == 0 else (n, k)).astype(np.float32)
    tb = torch.from_numpy(beta)
    want = np.asarray(jw.table_matvec_fused(jidx, jnp.asarray(beta)))
    np.testing.assert_allclose(bin_fused_matvec_op(tidx, tb).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(tw.table_matvec_fused(tidx, tb).numpy(), want,
                               atol=1e-5)
    tables = np.asarray(jw.table_loads(jidx, jnp.asarray(beta)))
    got_tables = bin_loads_blocked_op(tidx, tb)
    np.testing.assert_allclose(got_tables.numpy(), tables, atol=1e-5)
    np.testing.assert_allclose(tw.table_loads(tidx, tb).numpy(), tables,
                               atol=1e-5)
    want_ro = np.asarray(jw.table_readout(jidx, jnp.asarray(tables)))
    np.testing.assert_allclose(bin_readout_op(tidx, got_tables).numpy(),
                               want_ro, atol=1e-5)
    np.testing.assert_allclose(
        tw.table_readout(tidx, got_tables, average=False).numpy(),
        np.asarray(jw.table_readout(jidx, jnp.asarray(tables),
                                    average=False)), atol=1e-5)


@pytest.mark.parametrize("k", [0, 2])
def test_plain_binning_matches_pallas_interpret(k):
    """Plain B2/B3/B4 on the same layout arrays as the TPU kernels."""
    m, n, table_size = 2, 200, 1024
    slot, coeff = _slots(10 + k, m, n, table_size)
    j, t = _pair(slot, coeff, table_size)
    rng = np.random.default_rng(k)
    L = t.slot_lay.shape[1]
    shape = (m, L) if k == 0 else (m, k, L)
    real = np.asarray(j.coeff_lay) != 0
    beta_lay = rng.standard_normal(shape).astype(np.float32)
    beta_lay *= real if k == 0 else real[:, None, :]
    width = t.num_tiles * t.block_t
    want = np.asarray(bin_fused_matvec_pallas(
        j.v_block, j.v_tile, j.v_phase, j.slot_lay, j.coeff_lay,
        jnp.asarray(beta_lay), block_n=j.block_n, block_t=j.block_t,
        interpret=True))
    got = fused_matvec_ref(t.slot_lay, t.coeff_lay,
                           torch.from_numpy(beta_lay), width=width).numpy()
    mask = real if k == 0 else np.broadcast_to(real[:, None, :], shape)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5)
    contrib = beta_lay * (np.asarray(j.coeff_lay) if k == 0
                          else np.asarray(j.coeff_lay)[:, None, :])
    want_t = np.asarray(bin_scatter_blocked_pallas(
        j.vs_block, j.vs_tile, j.slot_lay, jnp.asarray(contrib),
        num_tiles=j.num_tiles, block_n=j.block_n, block_t=j.block_t,
        interpret=True))
    got_t = scatter_blocked_ref(t.slot_lay, torch.from_numpy(contrib),
                                width=width)
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=1e-5)
    if k == 0:
        q = np.random.default_rng(5).integers(0, table_size, (m, 256)) \
            .astype(np.int32)
        want_g = np.asarray(bin_gather_pallas(
            jnp.asarray(q), jnp.asarray(want_t), interpret=True,
            block_n=128, block_t=512))
        got_g = gather_ref(torch.from_numpy(q), got_t).numpy()
        np.testing.assert_allclose(got_g, want_g, atol=1e-5)


def test_matvec_of_zero_weights_is_zero():
    slot, coeff = _slots(4, 2, 130, 512)
    coeff[:] = 0.0
    _, tidx = _indexes(slot, coeff, 512)
    beta = torch.randn(130, generator=torch.Generator().manual_seed(0))
    assert bool((bin_fused_matvec_op(tidx, beta) == 0).all())
