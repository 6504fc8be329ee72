"""WLSH estimator (paper Def. 6), table (CountSketch) mode.

Scatters signed loads into a dense table of size B per instance; collisions
are sign-randomized, so the estimator stays unbiased and the implied kernel
matrix stays PSD.  ``matvec`` computes (1/m) sum_s K~^s beta in O(n m).

The slot-blocked layout is built exactly as the JAX package builds it
(bitwise: a stable sort, the same searchsorted sides), with one addition the
CUDA kernels read instead of the visit lists: ``blk_start``, the first
layout block of every table tile.  Exact mode waits for a later slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lsh import Features, slots_from_features

# Default fused-kernel geometry: layout block and table tile (as in the JAX
# package, so the layouts compare bitwise).
BLOCKED_N = 128
BLOCKED_T = 512


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


def table_readout(index: TableIndex, tables: torch.Tensor, *,
                  average: bool = True) -> torch.Tensor:
    """Per-point readout: (1/m) sum_s coeff * tables[s, slot] (plain), or
    the plain instance sum when not ``average``."""
    rows = torch.arange(index.slot.shape[0], device=tables.device)[:, None]
    vals = _rowwise(index.coeff, tables[rows, index.slot.long()])
    return vals.mean(0) if average else vals.sum(0)


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
