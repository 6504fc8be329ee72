"""The fused matvec B2's numpy model on the CPU.

* ``repro_torch.testing.matvec_model`` (the kernel's chunks, lanes, run
  boundaries and float32 sum order) held against the port's plain versions
  (``fused_matvec_ref`` on beta laid out, ``fused_matvec_src_ref`` on beta
  in point order) and against the JAX package's ``bin_fused_matvec_pallas``
  in interpret mode, on the layouts of ``trap_layout``: one slot holding
  every point (tile 0's padding right after it), two slots, runs of a
  chunk's length and one less and one more, a run ending on a chunk's last
  position, an instance of zero coefficients.
* The card's form of ``bin_fused_matvec_op`` (B2's run totals, then the
  readout over ``inv_pos``) on the model, against the JAX package's op.

The card tests hold the kernel bit for bit against the same model.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wlsh as jw
from repro.kernels.binning import bin_fused_matvec_pallas
from repro.kernels.binning import ops as jops
from repro_torch.core import wlsh as tw
from repro_torch.kernels.binning import (bin_fused_matvec_op,
                                         fused_matvec_ref,
                                         fused_matvec_src_ref, readout_ref)
from repro_torch.kernels.binning.ops import layout_rows
from repro_torch.testing.matvec_model import (CHUNK, TRAPS,
                                              fused_matvec_model, trap_layout)

TABLE_SIZE = 1 << 12


def _points(seed, m=5, n=7000):
    return trap_layout(np.random.default_rng(seed), m=m, n=n,
                       table_size=TABLE_SIZE)


def _layout(slot, coeff, block_n=128, parts="kernel"):
    return tw.build_blocked_layout(slot, coeff, TABLE_SIZE, block_n=block_n,
                                   parts=parts)


def _beta(seed, n, k, integer):
    rng = np.random.default_rng(seed)
    shape = (n,) if k == 0 else (n, k)
    if integer:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _beta_lay(lay, beta):
    """beta laid out as the contract form reads it: (m, L) or (m, k, L)."""
    vals = layout_rows(lay, torch.from_numpy(beta))
    return vals if beta.ndim == 1 else vals.transpose(1, 2).contiguous()


@pytest.mark.parametrize("block_n", [128, 64])
def test_trap_layout_has_the_boundaries(block_n):
    """What ``trap_layout`` promises, in the layout: one slot over several
    chunks with tile 0's padding right after it; two slots; runs of CHUNK,
    CHUNK - 1 and CHUNK + 1 from position 0 (ends on positions CHUNK - 1
    and 3 CHUNK - 1, a start on CHUNK); zero coefficients."""
    slot, coeff = _points(block_n)
    lay = _layout(slot, coeff, block_n)
    n = slot.shape[1]
    one = TRAPS.index("one_slot")
    row, src = lay.slot_lay[one], lay.src[one]
    assert bool((row[:n] == 0).all()) and n > 3 * CHUNK
    assert bool((src[:n] < n).all()) and bool((src[n:] == n).all())
    assert int(lay.blk_start[one, 1]) * block_n > n    # padding of tile 0
    two = lay.slot_lay[TRAPS.index("two_slots")]
    assert int(torch.unique(two[lay.src[TRAPS.index("two_slots")] < n])
               .numel()) == 2
    runs = lay.slot_lay[TRAPS.index("chunk_runs")]
    bounds = [0, CHUNK, 2 * CHUNK - 1, 3 * CHUNK, 3 * CHUNK + 1]
    for value, (a, b) in zip((1, 2, 3, 4), zip(bounds, bounds[1:])):
        assert bool((runs[a:b] == value).all()), value
    assert int(runs[3 * CHUNK + 1]) != 4
    assert not bool(lay.coeff_lay[TRAPS.index("zero_coeff")].any())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("block_n", [128, 64])
def test_matvec_model_matches_plain(block_n, k, integer):
    """Both output forms of the model against the plain versions: with
    small-integer coefficients and beta every sum is exact in any order, so
    the run boundaries are held bit for bit (a run split at a chunk's edge,
    a carry lost or added twice, or tile 0's padding summed into slot 0
    would change an output); with float beta to 1e-5 of max|out| (a run
    of 7000 terms summed in two orders)."""
    slot, coeff = _points(7 + block_n + k)
    lay = _layout(slot, coeff, block_n)
    beta = _beta(k, slot.shape[1], k, integer)
    width = lay.num_tiles * lay.block_t
    want = fused_matvec_ref(lay.slot_lay, lay.coeff_lay, _beta_lay(lay, beta),
                            width=width).numpy()
    got = fused_matvec_model(lay.slot_lay, lay.coeff_lay, lay.src, beta)
    want_t = fused_matvec_src_ref(lay.slot_lay, lay.coeff_lay, lay.src,
                                  torch.from_numpy(beta), totals=True).numpy()
    got_t = fused_matvec_model(lay.slot_lay, lay.coeff_lay, lay.src, beta,
                               totals=True)
    assert got.shape == want.shape and got_t.shape == want_t.shape
    assert want_t.shape[:2] == tuple(lay.slot_lay.shape)
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_t, want_t)
        assert np.count_nonzero(want_t[TRAPS.index("one_slot")]) >= 7000
    else:
        for g, w in ((got, want), (got_t, want_t)):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("m,n,table_size,bn,bt", [
    (3, 300, 1024, 128, 512), (2, 5000, 1 << 14, 128, 512),
    (2, 64, 100, 16, 32), (1, 10, 1 << 14, 128, 512)])
def test_matvec_model_on_random_layouts(m, n, table_size, bn, bt):
    """Random slots at other geometries (narrow tiles, a layout shorter
    than a chunk, a last chunk cut short): integer inputs exactly."""
    rng = np.random.default_rng(n)
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32))
    coeff = torch.from_numpy(rng.integers(-3, 4, (m, n)).astype(np.float32))
    lay = tw.build_blocked_layout(slot, coeff, table_size, block_n=bn,
                                  block_t=bt)
    beta = rng.integers(-4, 5, n).astype(np.float32)
    got = fused_matvec_model(lay.slot_lay, lay.coeff_lay, lay.src, beta)
    want = fused_matvec_ref(lay.slot_lay, lay.coeff_lay, _beta_lay(lay, beta),
                            width=lay.num_tiles * bt).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
def test_matvec_model_matches_pallas_interpret(k):
    """The model's contract form against the TPU kernel (interpret mode)
    on the JAX package's own layout of the same trap points, beta laid out
    as the JAX op lays it out, at the real positions (the TPU kernel leaves
    the all-padding tail unwritten); 1e-5 of max|out| (the two sum in
    other orders).  The model writes 0 at every padding position."""
    slot, coeff = _points(40 + k)
    j = jw.build_blocked_layout(jnp.asarray(slot.numpy()),
                                jnp.asarray(coeff.numpy()), TABLE_SIZE)
    t = _layout(slot, coeff)
    beta = _beta(k, slot.shape[1], k, integer=False)
    beta_lay = _beta_lay(t, beta).numpy()
    want = np.asarray(bin_fused_matvec_pallas(
        j.v_block, j.v_tile, j.v_phase, j.slot_lay, j.coeff_lay,
        jnp.asarray(beta_lay), block_n=j.block_n, block_t=j.block_t,
        interpret=True))
    got = fused_matvec_model(t.slot_lay, t.coeff_lay, t.src, beta)
    assert got.shape == want.shape == (slot.shape[0], k, t.slot_lay.shape[1])
    real = np.broadcast_to((t.src < slot.shape[1]).numpy()[:, None],
                           got.shape)
    np.testing.assert_allclose(got[real], want[real], rtol=0,
                               atol=1e-5 * np.abs(want[real]).max())
    assert not got[~real].any()


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("k", [0, 3])
def test_matvec_op_point_order_matches_jax(k, average):
    """The card's form of the op on the CPU (the model's run totals, then
    the plain readout over inv_pos, coeff in point order) against the JAX
    package's ``bin_fused_matvec_op`` (Pallas in interpret mode) within
    1e-5 of max|out|; the port's CPU op within the same."""
    slot, coeff = _points(60 + k, m=4, n=6400)
    j = jw.build_blocked_layout(jnp.asarray(slot.numpy()),
                                jnp.asarray(coeff.numpy()), TABLE_SIZE)
    jidx = jw.TableIndex(slot=jnp.asarray(slot.numpy()), sign=None,
                         weight=None, coeff=jnp.asarray(coeff.numpy()),
                         table_size=TABLE_SIZE, blocked=j)
    lay = _layout(slot, coeff)
    tidx = tw.TableIndex(slot=slot, sign=None, weight=None, coeff=coeff,
                         table_size=TABLE_SIZE, blocked=lay)
    beta = _beta(k + 5, slot.shape[1], k, integer=False)
    want = np.asarray(jops.bin_fused_matvec_op(
        jidx, jnp.asarray(beta), average=average, interpret=True))
    totals = torch.from_numpy(fused_matvec_model(
        lay.slot_lay, lay.coeff_lay, lay.src, beta, totals=True))
    got = readout_ref(lay.inv_pos, coeff, totals, average).numpy()
    lim = 1e-5 * np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=lim)
    cpu = bin_fused_matvec_op(tidx, torch.from_numpy(beta), average=average)
    np.testing.assert_allclose(cpu.numpy(), want, rtol=0, atol=lim)
