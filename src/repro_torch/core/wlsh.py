"""WLSH estimator (paper Def. 6): its two matvec data structures.

* **exact** -- equal buckets grouped by a stable sort of the two 32-bit
  keys, bucket loads by a segment sum: the paper's estimator verbatim (up
  to 2^-64 hash collisions), the validation path.  ``perm`` and ``seg_id``
  are the JAX package's bit for bit, ties in point order.
* **table** (CountSketch) -- signed loads scattered into a dense table of
  size B per instance; collisions are sign-randomized, so the estimator
  stays unbiased and the implied kernel matrix stays PSD.

Both compute (1/m) sum_s K~^s beta in O(n m).

The slot-blocked layout is built exactly as the JAX package builds it
(bitwise: a stable sort, the same searchsorted sides), with one addition the
CUDA kernels read instead of the visit lists: ``blk_start``, the first
layout block of every table tile.  ``build_route_schedule`` is the JAX
package's hash-join visit schedule, also bitwise (and, like it, built with
no sort).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .bucket_fns import BucketFn
from .lsh import Features, LSHParams, slots_from_features

# Default fused-kernel geometry: layout block and table tile (as in the JAX
# package, so the layouts compare bitwise).
BLOCKED_N = 128
BLOCKED_T = 512

# Geometry of a layout that feeds the split loads -> readout kernels (the
# psum path of the distributed step, and the hash join), as in the JAX
# package.
BLOCKED_SPLIT_N = 64
BLOCKED_SPLIT_T = 512


class BlockedLayout(NamedTuple):
    """Slot-blocked point layout for a fixed (point set, table geometry).

    Points of every instance are stably sorted by slot and packed into
    ``block_n``-point blocks so that each block addresses one ``block_t``-slot
    table tile; tile t owns layout blocks [blk_start[s, t], blk_start[s, t+1]).
    ``L = NB * bn`` with ``NB = n // bn + ceil(B / bt)``; padding positions
    carry slot 0 and coeff 0.  Field meanings follow
    ``repro.core.wlsh.BlockedLayout``; groups not built are None.
    """

    # reference (sorted segment-sum) group:
    perm: torch.Tensor | None          # (m, n) int32 stable argsort of slot
    seg_id: torch.Tensor | None        # (m, n) int32 dense rank, sorted order
    seg_pt: torch.Tensor | None        # (m, n) int32 segment of point i
    coeff_sorted: torch.Tensor | None  # (m, n) float32
    # kernel group:
    inv_pos: torch.Tensor | None       # (m, n) int32 layout position of i
    src: torch.Tensor | None           # (m, L) int32 point per position (n=pad)
    slot_lay: torch.Tensor | None      # (m, L) int32
    coeff_lay: torch.Tensor | None     # (m, L) float32 (0 = pad)
    v_block: torch.Tensor | None       # (m, V) int32 visit lists of the
    v_tile: torch.Tensor | None        #   Pallas fused kernel (kept for
    v_phase: torch.Tensor | None       #   parity with the JAX layout)
    vs_block: torch.Tensor | None      # (m, NB) int32 Pallas split-scatter
    vs_tile: torch.Tensor | None       #   schedule
    vg_tile: torch.Tensor | None       # (m, NB) int32 block -> tile
    blk_start: torch.Tensor | None     # (m, T + 1) int32 first block of tile
    # always present:
    n_visits: torch.Tensor             # (m,) int32
    block_n: int
    block_t: int
    num_tiles: int


class TableIndex(NamedTuple):
    slot: torch.Tensor    # (m, n) int32 in [0, B)
    sign: torch.Tensor    # (m, n) float32
    weight: torch.Tensor  # (m, n) float32
    coeff: torch.Tensor   # (m, n) float32 weight*sign
    table_size: int
    blocked: BlockedLayout | None = None


def build_table_index(feats: Features, table_size: int) -> TableIndex:
    slot = feats.slot if feats.slot is not None else \
        slots_from_features(feats, table_size)
    coeff = feats.coeff if feats.coeff is not None else \
        feats.weight * feats.sign
    return TableIndex(slot=slot, sign=feats.sign, weight=feats.weight,
                      coeff=coeff, table_size=int(table_size))


def _searchsorted(seq, values, *, right: bool):
    """Row-wise searchsorted of ``values`` (1-D, shared by every row) in the
    rows of ``seq`` (m, K)."""
    vals = values.expand(seq.shape[0], -1).contiguous()
    return torch.searchsorted(seq.contiguous(), vals, right=right)


def _set_dropping(shape, fill, *updates):
    """Row-wise ``full(shape, fill).at[rows, idx].set(val)`` for each
    (idx, val) in turn, where idx may be one past the row (JAX's
    mode='drop'): a spare column takes those writes and is sliced off."""
    m, width = shape
    out = torch.full((m, width + 1), fill, dtype=torch.int32,
                     device=updates[0][0].device)
    for idx, val in updates:
        idx = idx.long()
        val = torch.as_tensor(val, dtype=torch.int32, device=out.device)
        out.scatter_(1, idx, val.expand_as(idx))
    return out[:, :width]


def build_blocked_layout(slot: torch.Tensor, coeff: torch.Tensor,
                         table_size: int, *, block_n: int = BLOCKED_N,
                         block_t: int = BLOCKED_T,
                         parts: str = "kernel") -> BlockedLayout:
    """One-off O(mn log n) construction of the slot-blocked layout.

    ``parts`` selects the array groups: 'reference' (sorted segment-sum),
    'kernel' (the layout the kernels read, with the JAX package's visit
    lists beside ``blk_start``) or 'both'.
    """
    if parts not in ("reference", "kernel", "both"):
        raise ValueError(f"unknown parts {parts!r}")
    want_ref = parts in ("reference", "both")
    want_ker = parts in ("kernel", "both")
    m, n = slot.shape
    dev = slot.device
    i32 = torch.int32
    bn, bt = int(block_n), int(block_t)
    num_tiles = -(-int(table_size) // bt)
    nb = n // bn + num_tiles
    layout_len = nb * bn
    n_vis = 2 * nb

    ss, order = torch.sort(slot, dim=1, stable=True)
    tile = ss // bt
    zcol = torch.zeros((m, 1), dtype=i32, device=dev)

    perm = seg_id = seg_pt = coeff_sorted = None
    if want_ref:
        new_seg = torch.cat([zcol, (ss[:, 1:] != ss[:, :-1]).to(i32)], dim=1)
        seg_id = torch.cumsum(new_seg, dim=1, dtype=i32)
        seg_pt = torch.zeros((m, n), dtype=i32, device=dev).scatter_(
            1, order, seg_id)
        perm = order.to(i32)
        coeff_sorted = coeff.gather(1, order)

    # tile t's sorted points are [bounds[t], bounds[t+1]) (left side)
    bounds = _searchsorted(tile, torch.arange(num_tiles + 1, dtype=i32,
                                              device=dev), right=False)
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(i32)
    kblocks = (counts + bn - 1) // bn
    blk_start = torch.cat([zcol, torch.cumsum(kblocks, 1, dtype=i32)], 1)
    total_blocks = blk_start[:, -1:]

    inv_pos = src = slot_lay = coeff_lay = None
    v_block = v_tile = v_phase = vs_block = vs_tile = vg_tile = None
    if want_ker:
        tile_l = tile.long()
        rank = torch.arange(n, dtype=i32, device=dev) - \
            bounds[:, :-1].gather(1, tile_l).to(i32)
        pos = blk_start.gather(1, tile_l) * bn + rank
        pos_l = pos.long()
        src = torch.full((m, layout_len), n, dtype=i32, device=dev).scatter_(
            1, pos_l, order.to(i32))
        slot_lay = torch.zeros((m, layout_len), dtype=i32,
                               device=dev).scatter_(1, pos_l, ss)
        coeff_lay = torch.zeros((m, layout_len), dtype=torch.float32,
                                device=dev).scatter_(
            1, pos_l, coeff.gather(1, order))
        inv_pos = torch.zeros((m, n), dtype=i32, device=dev).scatter_(
            1, order, pos)
        del tile_l, pos_l, rank, pos

        # Pallas fused visit list: per tile, scatter its blocks then gather
        barange = torch.arange(nb, dtype=i32, device=dev)
        block_tile = _searchsorted(blk_start[:, 1:], barange, right=True)
        block_tile = block_tile.clamp(max=num_tiles - 1)
        start_of = blk_start.gather(1, block_tile)
        q = barange - start_of
        v_s = 2 * start_of + q
        v_g = v_s + kblocks.gather(1, block_tile)
        real = barange < total_blocks
        vs_idx = torch.where(real, v_s, n_vis)
        vg_idx = torch.where(real, v_g, n_vis)
        bar = barange.expand(m, -1)
        v_block = _set_dropping((m, n_vis), 0, (vs_idx, bar), (vg_idx, bar))
        v_tile = _set_dropping((m, n_vis), 0, (vs_idx, block_tile),
                               (vg_idx, block_tile))
        v_phase = _set_dropping((m, n_vis), 0, (vg_idx, 1))
        last_b = (total_blocks - 1).clamp(min=0)
        pad = torch.arange(n_vis, dtype=i32, device=dev) >= 2 * total_blocks
        v_block = torch.where(pad, last_b, v_block)
        v_tile = torch.where(pad, block_tile.gather(1, last_b.long()).to(i32),
                             v_tile)
        v_phase = torch.where(pad, 1, v_phase).to(i32)

        # Pallas split-scatter schedule (every tile visited at least once)
        ksched = kblocks.clamp(min=1)
        vstart = torch.cat([zcol, torch.cumsum(ksched, 1, dtype=i32)], 1)
        total_sched = vstart[:, -1:]
        s_tile = _searchsorted(vstart[:, 1:], barange, right=True)
        s_tile = s_tile.clamp(max=num_tiles - 1)
        q_s = barange - vstart.gather(1, s_tile)
        s_block = torch.where(counts.gather(1, s_tile) > 0,
                              blk_start.gather(1, s_tile) + q_s, nb - 1)
        pad_s = barange >= total_sched
        vs_tile = torch.where(pad_s, num_tiles - 1, s_tile).to(i32)
        vs_block = torch.where(pad_s, nb - 1, s_block).to(i32)
        vg_tile = torch.where(barange < total_blocks, block_tile, 0).to(i32)

    return BlockedLayout(perm=perm, seg_id=seg_id, seg_pt=seg_pt,
                         coeff_sorted=coeff_sorted, inv_pos=inv_pos, src=src,
                         slot_lay=slot_lay, coeff_lay=coeff_lay,
                         v_block=v_block, v_tile=v_tile, v_phase=v_phase,
                         vs_block=vs_block, vs_tile=vs_tile, vg_tile=vg_tile,
                         blk_start=blk_start if want_ker else None,
                         n_visits=(2 * total_blocks[:, 0]).to(i32),
                         block_n=bn, block_t=bt, num_tiles=num_tiles)


class RouteSchedule(NamedTuple):
    """Visit schedules of the JAX package's Pallas route kernels (fields as
    in ``repro.core.wlsh.RouteSchedule``): a flat pack schedule segmented by
    destination-cell tile and per-instance unpack lists.  The CUDA route
    kernels read ``cell_lay`` directly (a run head sums its run; see
    csrc/route.cu), so the port's step does not build it; it is kept, and
    pinned bitwise against the JAX package, as the reference statement of
    the cell layout's monotonicity contract."""

    p_inst: torch.Tensor   # (V,) int32 flat pack schedule: instance,
    p_block: torch.Tensor  #   layout block,
    p_tile: torch.Tensor   #   destination cell tile,
    p_flag: torch.Tensor   #   0 accumulate, 1 zero the tile, 2 no-op
    u_block: torch.Tensor  # (m, VB) int32 per-instance unpack schedule
    u_tile: torch.Tensor
    u_flag: torch.Tensor   #   0 compute, 2 no-op padding
    num_cell_tiles: int
    block_t: int


def _enumerate_visits(c, lo, vb: int):
    """(block, tile, valid) of each of vb visits per row: block b gets c[b]
    consecutive visits covering tiles [lo[b], lo[b] + c[b])."""
    lb = c.shape[1]
    start = torch.cumsum(c, 1) - c                            # exclusive
    total = start[:, -1:] + c[:, -1:]
    v = torch.arange(vb, dtype=c.dtype, device=c.device)
    b = _searchsorted(start, v, right=True) - 1
    b = b.clamp(0, lb - 1)
    t = lo.gather(1, b) + v - start.gather(1, b)
    return b, t, v < total


def build_route_schedule(cell_lay: torch.Tensor, *, num_cell_tiles: int,
                         block_n: int, block_t: int) -> RouteSchedule:
    """Both route-kernel schedules from ``cell_lay`` (m, L) int32, whose
    real cells are non-decreasing along each instance's layout and whose
    dropped/padding positions hold the sentinel ``num_cell_tiles*block_t``.
    Cumsums and searchsorted only: no sort."""
    m, layout_len = cell_lay.shape
    bn, bt = int(block_n), int(block_t)
    lb = layout_len // bn
    cb = int(num_cell_tiles)
    sentinel = cb * bt
    dev = cell_lay.device
    cells = cell_lay.long().view(m, lb, bn)
    real = cells < sentinel
    any_real = real.any(2)
    lo = torch.where(real, cells, sentinel).amin(2) // bt
    hi = torch.where(real, cells, -1).amax(2) // bt
    c = torch.where(any_real, hi - lo + 1, 0)
    lo = torch.where(any_real, lo, 0)
    vb = lb + cb
    rows = torch.arange(m, device=dev)[:, None]

    # pack: one flat schedule segmented by destination tile
    pb, pt, pvalid = _enumerate_visits(c, lo, vb)
    pt = torch.where(pvalid, pt, cb - 1)
    first = torch.searchsorted(pt, pt, right=False)
    prank = torch.arange(vb, device=dev)[None, :] - first
    cnt = torch.zeros((m, cb), dtype=torch.long, device=dev).scatter_add_(
        1, pt, pvalid.long())
    seg_size = 1 + cnt.sum(0)
    seg_start = torch.cumsum(seg_size, 0) - seg_size
    inst_off = torch.cumsum(cnt, 0) - cnt
    v_cap = cb + m * vb
    fp = torch.where(pvalid, seg_start[pt] + 1 + inst_off.gather(1, pt)
                     + prank, v_cap).view(-1)

    def placed(fill, vals):
        # JAX's full(v_cap, fill).at[fp].set(vals, mode="drop"): a spare
        # slot takes the dropped writes
        out = torch.full((v_cap + 1,), fill, dtype=torch.long, device=dev)
        out.scatter_(0, fp, torch.as_tensor(vals, device=dev).expand(
            m, vb).reshape(-1))
        return out[:v_cap]

    p_inst = placed(0, rows)
    p_block = placed(0, pb)
    p_tile = placed(cb - 1, pt)
    p_flag = placed(2, 0)
    p_tile[seg_start] = torch.arange(cb, device=dev)
    p_flag[seg_start] = 1

    # unpack: per instance, every block visited at least once
    cu = c.clamp(min=1)
    ub, ut, uvalid = _enumerate_visits(cu, lo, vb)
    last_t = lo[:, -1:] + cu[:, -1:] - 1
    ub = torch.where(uvalid, ub, lb - 1)
    ut = torch.where(uvalid, ut, last_t)
    u_flag = torch.where(uvalid, 0, 2)
    i32 = torch.int32
    return RouteSchedule(p_inst=p_inst.to(i32), p_block=p_block.to(i32),
                         p_tile=p_tile.to(i32), p_flag=p_flag.to(i32),
                         u_block=ub.to(i32), u_tile=ut.to(i32),
                         u_flag=u_flag.to(i32), num_cell_tiles=cb,
                         block_t=bt)


def _colwise(coeff: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """coeff (m, n) times a point vector beta (n,) or block (n, k)."""
    return coeff * beta if beta.ndim == 1 else coeff[..., None] * beta


def _rowwise(coeff: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """coeff (m, n) times per-instance values (m, n) or (m, n, k)."""
    return coeff * vals if vals.ndim == 2 else coeff[..., None] * vals


def table_loads(index: TableIndex, beta: torch.Tensor) -> torch.Tensor:
    """Bucket-load tables for all m instances: (m, B) for beta (n,), or
    (m, B, k) for a (n, k) block (plain version: ``index_add_``)."""
    contrib = _colwise(index.coeff, beta)
    m, n = index.slot.shape
    b = index.table_size
    tail = tuple(beta.shape[1:])
    flat = index.slot.long() + b * torch.arange(m, device=beta.device)[:, None]
    tables = torch.zeros((m * b,) + tail, dtype=contrib.dtype,
                         device=beta.device)
    tables.index_add_(0, flat.reshape(-1), contrib.reshape((m * n,) + tail))
    return tables.reshape((m, b) + tail)


def instance_sum_(vals: torch.Tensor) -> torch.Tensor:
    """Sum over the instances (dim 0), in place in ``vals``, in a pairwise
    order fixed by their count alone: row s plus row s + h, halving (an odd
    last row carried to the next round) until one row is left.  A point's
    sum is then the same bits whatever the other points are (a serving
    bucket padded differently, a data shard of the batch), which ``sum(0)``
    on the CPU does not promise: its order follows the shape."""
    m = vals.shape[0]
    while m > 1:
        h = m // 2
        vals[:h] += vals[h:2 * h]
        if m % 2:
            vals[h] = vals[2 * h]
        m = h + m % 2
    return vals[0]


def combine_instances(coeff: torch.Tensor, vals: torch.Tensor,
                      average: bool = True) -> torch.Tensor:
    """The readout's combine: (1/m) sum_s coeff * vals (plain), or the plain
    instance sum when not ``average`` (``instance_sum_``'s order); vals
    (m, n) or (m, n, k)."""
    out = instance_sum_(_rowwise(coeff, vals))
    return out / coeff.shape[0] if average else out


def point_readout(slot: torch.Tensor, coeff: torch.Tensor,
                  tables: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Per-point readout of tables (m, B) or (m, B, k) at slot and coeff
    (m, n): (1/m) sum_s coeff * tables[s, slot] (plain), or the sum."""
    rows = torch.arange(slot.shape[0], device=tables.device)[:, None]
    return combine_instances(coeff, tables[rows, slot.long()], average)


def table_readout(index: TableIndex, tables: torch.Tensor, *,
                  average: bool = True) -> torch.Tensor:
    """Per-point readout: (1/m) sum_s coeff * tables[s, slot] (plain), or
    the plain instance sum when not ``average``."""
    return point_readout(index.slot, index.coeff, tables, average)


def table_matvec_fused(index: TableIndex, beta: torch.Tensor, *,
                       average: bool = True) -> torch.Tensor:
    """Fused table matvec via the sorted segment-sum (reference group): the
    (m, B) table is never materialized.  Plain PyTorch."""
    lay = index.blocked
    if lay is None or lay.perm is None:
        raise ValueError("fused matvec needs a slot-blocked index with the "
                         "reference group (parts='reference'|'both')")
    m, n = index.slot.shape
    tail = tuple(beta.shape[1:])
    off = n * torch.arange(m, device=beta.device)[:, None]
    contrib = _rowwise(lay.coeff_sorted, beta[lay.perm.long()])
    loads = torch.zeros((m * n,) + tail, dtype=contrib.dtype,
                        device=beta.device)
    loads.index_add_(0, (lay.seg_id.long() + off).reshape(-1),
                     contrib.reshape((m * n,) + tail))
    vals = loads[(lay.seg_pt.long() + off).reshape(-1)].reshape((m, n) + tail)
    outs = _rowwise(index.coeff, vals)
    return outs.mean(0) if average else outs.sum(0)


def table_matvec(index: TableIndex, beta: torch.Tensor) -> torch.Tensor:
    """The split table matvec, loads then readout (plain version)."""
    return table_readout(index, table_loads(index, beta))


def table_kernel_matrix(index: TableIndex) -> torch.Tensor:
    """Explicit CountSketch kernel matrix (tests only): PSD by
    construction."""
    eq = index.slot[:, :, None] == index.slot[:, None, :]
    cc = index.coeff[:, :, None] * index.coeff[:, None, :]
    return (eq * cc).mean(0)


# ---------------------------------------------------------------------------
# exact mode: sort + segment sum
# ---------------------------------------------------------------------------

class ExactIndex(NamedTuple):
    """Per-instance sorted bucket structure for a fixed point set."""

    perm: torch.Tensor    # (m, n) int32 sort order by (key1, key2)
    seg_id: torch.Tensor  # (m, n) int32 bucket id of sorted position
    weight: torch.Tensor  # (m, n) float32 WLSH weights (point order)


def _u32(key: torch.Tensor) -> torch.Tensor:
    """uint32 key bits as int64 values in [0, 2^32)."""
    return key.view(torch.int32).to(torch.int64) & 0xFFFF_FFFF


def build_exact_index(feats: Features) -> ExactIndex:
    """The JAX package's ``lexsort((key2, key1))`` per instance as one
    stable sort of the int64 key (key1 - 2^31) * 2^32 + key2, which orders
    as the pair of uint32 keys does (the bias keeps key1 >= 2^31 from
    wrapping negative); equal keys keep their point order."""
    key = (_u32(feats.key1) - 2 ** 31) * 2 ** 32 + _u32(feats.key2)
    sk, order = torch.sort(key, dim=1, stable=True)
    del key
    i32 = torch.int32
    new_seg = torch.cat([torch.zeros((sk.shape[0], 1), dtype=i32,
                                     device=sk.device),
                         (sk[:, 1:] != sk[:, :-1]).to(i32)], dim=1)
    del sk
    return ExactIndex(perm=order.to(i32),
                      seg_id=torch.cumsum(new_seg, dim=1, dtype=i32),
                      weight=feats.weight)


def exact_matvec(index: ExactIndex, beta: torch.Tensor) -> torch.Tensor:
    """(1/m) sum_s K~^s beta in O(m n) after the one-off sort; beta (n,) or
    (n, k).  One segment sum for all m instances: instance s's segments
    are offset by s * n.  Plain PyTorch (``index_add_``)."""
    m, n = index.perm.shape
    tail = tuple(beta.shape[1:])
    idx = torch.int32 if m * n < 2 ** 31 else torch.int64
    base = (torch.arange(m, dtype=idx, device=beta.device) * n)[:, None]
    flat_perm = (index.perm.to(idx) + base).view(-1)
    flat_seg = (index.seg_id.to(idx) + base).view(-1)
    del base
    w_sorted = index.weight.reshape(-1).index_select(0, flat_perm).view(m, n)
    contrib = _rowwise(w_sorted, beta.index_select(
        0, index.perm.view(-1)).view((m, n) + tail))
    loads = torch.zeros((m * n,) + tail, dtype=contrib.dtype,
                        device=beta.device)
    loads.index_add_(0, flat_seg, contrib.view((m * n,) + tail))
    del contrib
    out_sorted = _rowwise(w_sorted, loads.index_select(0, flat_seg).view(
        (m, n) + tail))
    del loads, w_sorted
    out = torch.empty_like(out_sorted).view((m * n,) + tail)
    out.index_copy_(0, flat_perm.long(), out_sorted.view((m * n,) + tail))
    return out.view((m, n) + tail).mean(0)


def exact_kernel_matrix(feats: Features) -> torch.Tensor:
    """Explicit K~ = (1/m) sum_s K~^s, O(m n^2): tests and small n only."""
    k1, k2 = _u32(feats.key1), _u32(feats.key2)
    eq = (k1[:, :, None] == k1[:, None, :]) & \
        (k2[:, :, None] == k2[:, None, :])
    ww = feats.weight[:, :, None] * feats.weight[:, None, :]
    return (eq * ww).mean(0)


# ---------------------------------------------------------------------------
# estimator facade
# ---------------------------------------------------------------------------

class WLSHEstimator(NamedTuple):
    """m independent WLSH instances bound to a bucket fn."""

    params: LSHParams
    bucket_name: str
    mode: str            # 'exact' | 'table'
    table_size: int

    def featurize(self, f: BucketFn, x) -> Features:
        from ..kernels.featurize import featurize_op
        return featurize_op(self.params, f, x)


def make_matvec(feats: Features, mode: str = "exact", table_size: int = 0):
    """(matvec_fn, index): the matvec closes over the prebuilt index (the
    paper's O(dn) preprocessing / O(n) matvec split).  Table mode runs the
    split matvec on the binning kernels (B5, then the readout) on the
    card."""
    if mode == "exact":
        idx = build_exact_index(feats)
        return functools.partial(exact_matvec, idx), idx
    if mode == "table":
        if table_size <= 0:
            raise ValueError("table mode needs table_size > 0")
        from ..kernels.binning import table_matvec_op
        idx = build_table_index(feats, table_size)
        return functools.partial(table_matvec_op, idx), idx
    raise ValueError(f"unknown mode {mode!r}")
