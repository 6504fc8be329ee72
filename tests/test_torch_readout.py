"""The fused readout (B4 with its combine) and the blocked scatter B3's run
boundaries, on the CPU.

* ``readout_ref`` against the JAX package's readout: ``bin_gather_pallas``
  in interpret mode (as tests/test_pallas_kernels.py runs it), times the
  coefficients, then the mean or the sum over the instances.
* The numpy model of B3 (``repro_torch.testing.scatter_model``: the
  kernel's chunks, lanes, run boundaries and float32 sum order) held
  exactly against ``scatter_blocked_ref`` on layouts with the boundaries
  the kernel must get right.  The card tests hold the kernel bitwise
  against the same model.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.binning import bin_gather_pallas
from repro_torch.core.wlsh import TableIndex, build_blocked_layout
from repro_torch.kernels.binning import readout_ref, scatter_blocked_ref
from repro_torch.kernels.binning.kernel import readout_group
from repro_torch.kernels.binning.ops import bin_readout_op
from repro_torch.testing.scatter_model import (CHUNK, scatter_blocked_model,
                                               trap_layout_case)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_readout_ref_matches_jax_gather_readout(k, average):
    """Same numpy inputs; the JAX side gathers column by column through the
    Pallas kernel (tables (m, B) only).  Tolerance 1e-6 of max|out|: the
    two sum the m products in different orders."""
    rng = np.random.default_rng(30 + k)
    m, n, b = 3, 256, 1024
    slot = rng.integers(0, b, (m, n)).astype(np.int32)
    coeff = rng.standard_normal((m, n)).astype(np.float32)
    tables = rng.standard_normal((m, b, k)).astype(np.float32)
    cols = [np.asarray(bin_gather_pallas(
        jnp.asarray(slot), jnp.asarray(tables[..., j]), interpret=True,
        block_n=min(1024, n), block_t=min(512, b))) for j in range(k)]
    signed = coeff[..., None] * np.stack(cols, -1)
    want = signed.mean(0) if average else signed.sum(0)
    t = torch.from_numpy(tables if k > 1 else tables[..., 0])
    got = readout_ref(torch.from_numpy(slot), torch.from_numpy(coeff), t,
                      average).numpy()
    assert got.shape == ((n, k) if k > 1 else (n,))
    np.testing.assert_allclose(got.reshape(n, k), want,
                               atol=1e-6 * np.abs(want).max(), rtol=0)
    # the op on CPU tensors takes the plain readout
    idx = TableIndex(slot=torch.from_numpy(slot), sign=None, weight=None,
                     coeff=torch.from_numpy(coeff), table_size=b,
                     blocked=None)
    assert torch.equal(bin_readout_op(idx, t, average=average),
                       torch.from_numpy(got))


def test_readout_group_by_regime():
    """16 instances a launch for predict's batches (a quarter of a read per
    table sector); one a launch for the distributed step's 2^22 points (4
    reads a sector, a 32 MiB table in a 50 MB L2), more where more tables
    fit half the L2; never more than m."""
    l2 = 50 * 2 ** 20
    assert readout_group(64, 1 << 18, 1 << 23, 1, l2) == 16
    assert readout_group(64, 1 << 22, 1 << 23, 1, l2) == 1
    assert readout_group(64, 1 << 22, 1 << 20, 1, l2) == 6
    assert readout_group(3, 1 << 22, 1 << 10, 4, l2) == 3
    assert readout_group(64, 1 << 22, 1 << 23, 4, l2) == 16   # too large
    assert readout_group(5, 100, 1 << 23, 1, l2) == 5


def _trap_layout(block_n, seed=0):
    rng = np.random.default_rng(seed)
    slot, coeff = trap_layout_case(rng, block_n=block_n)
    return build_blocked_layout(slot, coeff, 1 << 12, block_n=block_n,
                                block_t=512)


@pytest.mark.parametrize("block_n", [128, 64])
def test_trap_layout_has_the_boundaries(block_n):
    """What ``trap_layout_case`` promises, on every instance: tile 0's
    points end above slot 0 and padding of slot 0 follows; tile 1 is
    empty; tile 2 is one slot longer than a chunk; tile 3 has a run across
    its first chunk's end."""
    lay = _trap_layout(block_n)
    bs = lay.blk_start.long() * block_n
    for s in range(lay.blk_start.shape[0]):
        row = lay.slot_lay[s]
        t0 = row[bs[s, 0]:bs[s, 1]]
        real = lay.coeff_lay[s, bs[s, 0]:bs[s, 1]] != 0
        assert t0[0] == 0 and bool(real[:5].all()) and int(t0[64]) > 0
        assert not bool(real[65:].any()) and len(t0) > 65
        assert bool((t0[65:] == 0).all())
        assert bs[s, 1] == bs[s, 2]                         # tile 1 empty
        t2 = row[bs[s, 2]:bs[s, 2] + 300]
        assert bool((t2 == 2 * 512 + 7).all()) and 300 > CHUNK
        t3 = row[bs[s, 3]:bs[s, 4]]
        assert bool((t3[120:141] == 3 * 512 + 200).all())


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("block_n", [128, 64])
def test_scatter_model_matches_plain_exactly(block_n, k):
    """Small-integer contributions (every sum exact in any order), so the
    model's run boundaries are held bit for bit: a store of tile 0's
    padding run over slot 0, a run lost at a chunk's end or a run split in
    two would each change a table entry."""
    lay = _trap_layout(block_n, seed=block_n + (k or 0))
    contrib = lay.coeff_lay if k is None else \
        lay.coeff_lay[:, None, :] * torch.arange(
            1, k + 1, dtype=torch.float32)[None, :, None]
    width = lay.num_tiles * lay.block_t
    got = scatter_blocked_model(lay.blk_start, lay.slot_lay, contrib,
                                block_n=block_n, block_t=lay.block_t)
    want = scatter_blocked_ref(lay.slot_lay, contrib, width=width).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(want[..., 0]) == want[..., 0].size   # slot 0


@pytest.mark.parametrize("m,n,table_size,bn,bt", [
    (2, 300, 256, 16, 32), (3, 1000, 4096, 128, 384), (1, 10, 1 << 14, 128,
                                                       512)])
def test_scatter_model_on_random_layouts(m, n, table_size, bn, bt):
    """Random slots at other geometries (tiles narrower than a chunk, a
    tile width that is no power of 2, nearly empty tables): integer
    contributions exactly, and float ones to 1e-6 of max|out|."""
    rng = np.random.default_rng(n)
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32))
    coeff = torch.from_numpy(rng.integers(-3, 4, (m, n)).astype(np.float32))
    lay = build_blocked_layout(slot, coeff, table_size, block_n=bn,
                               block_t=bt)
    width = lay.num_tiles * bt
    for contrib, exact in ((lay.coeff_lay, True), (lay.coeff_lay * torch.randn(
            lay.coeff_lay.shape, generator=torch.Generator().manual_seed(n)),
            False)):
        got = scatter_blocked_model(lay.blk_start, lay.slot_lay, contrib,
                                    block_n=bn, block_t=bt)
        want = scatter_blocked_ref(lay.slot_lay, contrib, width=width).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
