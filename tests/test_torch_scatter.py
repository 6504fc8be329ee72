"""The distributed step's two scatter kernels, B5 (point scatter) and B7
(route pack), on the CPU: each owner's dense range of wire cells (``used``)
against the plain pack and the JAX package's routing maps, B5's partition
schedule emulated in PyTorch against ``scatter_ref``, and the hash join's
bf16 send, now rounded by the pack itself, bitwise against the cast-after
path and the JAX package's send payload."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as J
from repro.core.wlsh import build_blocked_layout as j_layout
from repro_torch.core import distributed as D
from repro_torch.core.wlsh import (BLOCKED_SPLIT_N, BLOCKED_SPLIT_T,
                                   build_blocked_layout)
from repro_torch.kernels.binning import route_pack_ref, scatter_ref
from repro_torch.kernels.binning.kernel import (SCATTER_SCRATCH_BYTES,
                                                scatter_plan)
from repro_torch.kernels.binning.ops import layout_rows


def _setup(n_shards, cap_factor, m=3, n=300, table_size=1024, seed=11):
    """Slots with a heavy bucket (40 points), both frameworks' split
    layouts, routing maps and the port's wire-cell layout."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, table_size, (m, n)).astype(np.int32)
    slot[:, :40] = 7
    coeff = rng.standard_normal((m, n)).astype(np.float32)
    jlay = j_layout(jnp.asarray(slot), jnp.asarray(coeff), table_size,
                    block_n=BLOCKED_SPLIT_N, block_t=BLOCKED_SPLIT_T,
                    parts="both")
    tlay = build_blocked_layout(torch.from_numpy(slot),
                                torch.from_numpy(coeff), table_size,
                                block_n=BLOCKED_SPLIT_N,
                                block_t=BLOCKED_SPLIT_T, parts="both")
    jmaps = J._routing_maps(jnp.asarray(slot), jlay, n_shards, table_size,
                            cap_factor)
    tmaps = D._routing_maps(torch.from_numpy(slot), tlay, n_shards,
                            table_size, cap_factor)
    cell_lay = D._make_route_plan(tmaps[0], tlay, n_shards * tmaps[3])
    return slot, coeff, jlay, tlay, jmaps, tmaps, cell_lay


@pytest.mark.parametrize("cap_factor", [2.0, 0.05])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_used_is_each_owners_dense_cell_range(n_shards, cap_factor):
    """``used[o]`` cells of owner o are exactly [o*cap, o*cap + used[o]):
    the cells the layout reaches, the cells the plain pack writes (with
    positive contributions), and the JAX package's filled send slots;
    cap_factor 0.05 drops buckets, so some owners are full."""
    _, _, _, _, jmaps, tmaps, cell_lay = _setup(n_shards, cap_factor)
    cap, used = tmaps[3], tmaps[6]
    assert used.dtype == torch.int32 and tuple(used.shape) == (n_shards,)
    nb = n_shards * cap
    dense = torch.zeros(nb, dtype=torch.bool)
    for o, u in enumerate(used.tolist()):
        assert 0 < u <= cap
        dense[o * cap: o * cap + u] = True
    reached = torch.zeros(nb, dtype=torch.bool)
    reached[cell_lay[cell_lay < nb].long()] = True
    assert torch.equal(reached, dense)
    contrib = torch.rand(cell_lay.shape) + 0.5
    send = route_pack_ref(cell_lay, contrib, num_cells=nb)
    assert torch.equal(send != 0, dense)
    filled = np.asarray(jmaps[1]) >= 0                       # (n_shards, cap)
    np.testing.assert_array_equal(filled.sum(1), used.numpy())
    np.testing.assert_array_equal(filled.reshape(-1), dense.numpy())
    if cap_factor < 1:
        assert int(tmaps[4]) > 0 and int(used.max()) == cap


def _emulate_partitioned_scatter(slot, contrib, table_size, **plan_kw):
    """B5's schedule in PyTorch, as csrc/binning.cu runs it: per group of
    instances, group of columns and window of bins, count each chunk's
    points per bin of the window, scan the counts into bin offsets, write
    every such point's (slot within the bin, contrib columns) pair into its
    bin's run, then sum each (instance, bin) run into a zeroed tile and
    write the tile over the table's columns, which start as garbage (the
    kernel's ``torch.empty``).  Returns the tables, how often each
    (instance, slot, column) was written, and the plan."""
    m, n = slot.shape
    k = contrib.shape[2] if contrib.ndim == 3 else 1
    c3 = contrib.reshape(m, n, k)
    plan = scatter_plan(m, n, table_size, k, **plan_kw)
    w, p_all, win, kc, c, g, _ = plan
    tables = torch.full((m, table_size, k), float("nan"))
    written = torch.zeros((m, table_size, k), dtype=torch.int32)
    for g0, j0, b0 in itertools.product(range(0, m, g), range(0, k, kc),
                                        range(0, p_all, win)):
        rows, cols = range(g0, min(m, g0 + g)), slice(j0, min(k, j0 + kc))
        p = min(win, p_all - b0)
        pslot = torch.full((len(rows) * n,), -1, dtype=torch.int32)
        pval = torch.full((len(rows) * n, cols.stop - j0), float("nan"))
        for r, s in enumerate(rows):
            pbin = slot[s].long() // w - b0     # the bin within the window
            inwin = (pbin >= 0) & (pbin < p)
            counts = torch.zeros(p, dtype=torch.int64)
            for c0 in range(0, n, c):                      # part_hist
                counts += torch.bincount(pbin[c0:c0 + c][inwin[c0:c0 + c]],
                                         minlength=p)
            offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                                 counts.cumsum(0)])         # part_scan
            assert int(offsets[-1]) == int(inwin.sum())
            cursor = r * n + offsets[:-1].clone()
            for c0 in range(0, n, c):                      # part_scatter
                pb = pbin[c0:c0 + c]
                for b in torch.unique(pb[inwin[c0:c0 + c]]).tolist():
                    sel = pb == b
                    q = int(cursor[b])
                    cnt = int(sel.sum())
                    assert bool((pslot[q:q + cnt] == -1).all())
                    pslot[q:q + cnt] = (slot[s, c0:c0 + c][sel]
                                        - (b0 + b) * w).int()
                    pval[q:q + cnt] = c3[s, c0:c0 + c][sel][:, cols]
                    cursor[b] += cnt
            assert torch.equal(cursor, r * n + offsets[1:])
            for b in range(p):                             # bin_accumulate
                lo = (b0 + b) * w
                width = min(w, table_size - lo)
                run = slice(r * n + int(offsets[b]),
                            r * n + int(offsets[b + 1]))
                ls = pslot[run].long()
                assert bool((ls >= 0).all()) and bool((ls < width).all())
                tile = torch.zeros((width, cols.stop - j0))
                tile.index_add_(0, ls, pval[run])
                tables[s, lo:lo + width, cols] = tile
                written[s, lo:lo + width, cols] += 1
    return tables.reshape((m, table_size) + tuple(contrib.shape[2:])), \
        written, plan


@pytest.mark.parametrize("plan_kw", [
    dict(tile_bytes=512, stage_bytes=2048),     # many bins and chunks
    dict(tile_bytes=600, stage_bytes=5000, scratch_bytes=30000),  # groups
    dict(tile_bytes=256, stage_bytes=2048, max_bins=5, max_cols=3),  # passes
    dict()])                                    # the defaults: one bin here
@pytest.mark.parametrize("k", [0, 1, 4, 7])
def test_scatter_partition_schedule_covers_each_slot_once(k, plan_kw):
    """Every (instance, slot, column) is written exactly once, by the one
    pass and bin that hold it (table_size 1000 leaves a ragged last bin),
    every point lands in its bin's run, and the result is
    ``scatter_ref``'s, a heavy slot of 900 points included."""
    rng = np.random.default_rng(20 + k)
    m, n, table_size = 5, 2000, 1000
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32))
    slot[:, :900] = 999
    shape = (m, n) if k == 0 else (m, n, k)
    contrib = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    tables, written, plan = _emulate_partitioned_scatter(
        slot, contrib, table_size, **plan_kw)
    assert bool((written == 1).all())
    if plan_kw:
        assert plan.bins > 1 and plan.chunk < n
    if "max_bins" in plan_kw:
        assert plan.window < plan.bins
        assert plan.cols < k or k < 4
    want = scatter_ref(slot, contrib, table_size=table_size)
    torch.testing.assert_close(tables, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def test_scatter_plan_at_the_step_shape():
    """At the step's shape (m = 64, n = 2^22, B = 2^23): bins of 16384
    slots (64 KiB tiles at k = 1; 4096 slots at k = 4), one pass of all
    bins and columns, chunks of 8192 points (16 a thread of 512; 3264 at
    k = 4, as the staging allows), groups of 16 instances whose pairs fit
    the scratch budget.  Wide tables and many columns take several passes:
    B = 2^23 at k = 32 two windows of 8192 bins of 512 slots, k = 40 two
    column groups of 20 (bins of 512 slots: a power of 2), k = 1 at
    B = 2^30 eight windows of bins of 16384 slots; a table smaller than a
    tile is one bin.  A block size that is no multiple of 32 raises."""
    plan = scatter_plan(64, 1 << 22, 1 << 23, 1)
    assert plan == (1 << 14, 1 << 9, 1 << 9, 1, 8192, 16, 512)
    assert plan.group * (1 << 22) * 6 <= SCATTER_SCRATCH_BYTES
    assert scatter_plan(64, 1 << 22, 1 << 23, 4)[:5] == (4096, 2048, 2048,
                                                         4, 3264)
    assert scatter_plan(2, 1 << 16, 1 << 23, 32)[:4] == (512, 16384, 8192,
                                                         32)
    assert scatter_plan(2, 1 << 16, 1 << 23, 40)[:4] == (512, 16384, 8192,
                                                         20)
    assert scatter_plan(1, 10, 1 << 30, 1)[:4] == (1 << 14, 1 << 16, 8192, 1)
    assert scatter_plan(4, 1 << 20, 1 << 20, 1, threads=64).chunk == 1024
    with pytest.raises(ValueError):
        scatter_plan(1, 10, 1000, 1, threads=100)
    with pytest.raises(ValueError):
        scatter_plan(1, 10, 1000, 1, max_bins=1 << 14)
    assert scatter_plan(3, 10, 1000, 1).bins == 1


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_hashjoin_send_bf16_is_bitwise(n_shards, k):
    """The bf16 send, rounded once by the pack, against the former path
    (the f32 pack, then ``.to(bfloat16)``) and against the JAX package's
    send payload (its flat f32 scatter-add, then ``astype``), compared as
    ``test_bf16_wire_cast_is_bitwise`` compares: the uint16 bit patterns.
    The f32 send equals the plain pack."""
    slot, coeff, jlay, tlay, jmaps, tmaps, cell_lay = _setup(n_shards, 2.0)
    cap, used = tmaps[3], tmaps[6]
    nb = n_shards * cap
    rng = np.random.default_rng(31)
    n = slot.shape[1]
    beta = rng.standard_normal((n,) if k is None else (n, k)
                               ).astype(np.float32)
    rt = D._Routing(cell_lay=cell_lay, recv_ids=torch.zeros(nb),
                    serve_map=None, spp=tmaps[2], cap=cap,
                    dropped=tmaps[4], used=used)
    lay = tlay._replace(perm=None, seg_id=None, seg_pt=None,
                        coeff_sorted=None)
    tail = () if k is None else (k,)
    got = D._hashjoin_send(rt, lay, torch.from_numpy(beta), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (n_shards, cap) + tail
    coeff_lay = lay.coeff_lay if k is None else lay.coeff_lay[..., None]
    f32 = route_pack_ref(cell_lay, coeff_lay * layout_rows(
        lay, torch.from_numpy(beta)), num_cells=nb)
    former = f32.to(torch.bfloat16).view((n_shards, cap) + tail)
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits(got), bits(former))
    jrt = J._Routing(pt_cell=jmaps[0], recv_ids=jnp.zeros(nb, jnp.int32),
                     serve_map=None, spp=jmaps[2], cap=jmaps[3],
                     dropped=jmaps[4])
    jsend = J._hashjoin_send(jrt, jlay, jnp.asarray(coeff),
                             jnp.asarray(beta), jnp.bfloat16,
                             interpret=True)
    np.testing.assert_array_equal(bits(got),
                                  np.asarray(jsend).view(np.uint16))
    got32 = D._hashjoin_send(rt, lay, torch.from_numpy(beta), torch.float32)
    assert torch.equal(got32, f32.view((n_shards, cap) + tail))
