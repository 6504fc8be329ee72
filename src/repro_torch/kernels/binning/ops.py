"""Public ops: the CountSketch matvec, table build and readout on the
binning kernels, and the hash-join route pack/unpack, dispatched on the
device of the index (the CUDA kernels on the card, their plain versions on
the CPU).

* ``bin_fused_matvec_op``  ~ ``table_matvec_fused`` — on the card two
  kernels and no glue tensors: B2 reads beta in point order through the
  layout's ``src`` and writes each layout position's run total (its slot's
  table entry, (m, L[, k])), then the readout combines coeff times each
  point's total over the instances in point order, through ``inv_pos``.
  The (m, B) table never exists.
* ``bin_loads_op``         ~ ``table_loads`` — the (m, B[, k]) psum-able
  tables: off the layout when the index has one (``bin_loads_blocked_op``),
  else the point scatter.
* ``bin_readout_op``       ~ ``table_readout`` — each point's bucket loads
  times its coefficients, combined over the instances: one kernel (the
  gather with the combine fused in), or over the layout when the index
  has one (``bin_readout_blocked_op``: gather, then combine).
* ``table_matvec_op`` — the split matvec, loads then readout (the tables
  round-trip through device memory: the psum-able path).
* ``route_pack_op`` / ``route_unpack_op`` — the hash join's wire pack and
  unpack along the layout.  The pack writes the wire dtype itself (the
  cast to bf16 is fused into B7, rounded once after the f32 run sums),
  and zeroes only the unreached tail of each owner's cells.

Around the other layout kernels (B3, B6), and on the CPU's plain path of
the fused matvec, beta is laid out through ``src`` and results map back
through ``inv_pos`` with PyTorch indexing (int32 indices, no int64
copies).
"""
from __future__ import annotations

import torch

from ...backend import on_card
from ...core.wlsh import TableIndex
from .kernel import (bin_fused_matvec_cuda, bin_gather_blocked_cuda,
                     bin_readout_cuda, bin_scatter_blocked_cuda,
                     bin_scatter_cuda, route_pack_cuda, route_unpack_cuda)
from .ref import (combine_ref, fused_matvec_ref, gather_blocked_ref,
                  readout_ref, route_pack_ref, route_unpack_ref,
                  scatter_blocked_ref, scatter_ref)


def _kernel_layout(index: TableIndex):
    """The slot-blocked layout when it carries the kernel group, else
    None."""
    lay = index.blocked
    return lay if lay is not None and lay.blk_start is not None else None


def _layout(index: TableIndex):
    lay = _kernel_layout(index)
    if lay is None:
        raise ValueError("needs a slot-blocked index with the kernel group; "
                         "build it with build_blocked_layout(parts='kernel'|"
                         "'both') / op.build_index(feats, blocked=True)")
    return lay


def layout_rows(lay, vals: torch.Tensor) -> torch.Tensor:
    """Point values (n,) or (n, k) laid out along the slot permutation:
    (m, L) or (m, L, k); padding positions read an appended zero row."""
    m, L = lay.src.shape
    tail = tuple(vals.shape[1:])
    pad = torch.zeros((1,) + tail, dtype=torch.float32, device=vals.device)
    padded = torch.cat([vals.to(torch.float32), pad])
    return padded.index_select(0, lay.src.view(-1)).view((m, L) + tail)


def _beta_to_layout(lay, beta: torch.Tensor) -> torch.Tensor:
    """beta (n,) or (n, k) laid out along the slot permutation: (m, L) or
    (m, k, L), the order the layout kernels B2 and B3 read."""
    lay_vals = layout_rows(lay, beta)
    if beta.ndim == 1:
        return lay_vals
    return lay_vals.transpose(1, 2).contiguous()


def rows_to_points(lay, out_lay: torch.Tensor) -> torch.Tensor:
    """Layout values (m, L) or (m, L, k) back to point order: (m, n) or
    (m, n, k), through ``inv_pos``."""
    m, L = lay.src.shape
    tail = tuple(out_lay.shape[2:])
    idx = torch.int32 if out_lay.shape[0] * L < 2 ** 31 else torch.int64
    rows = torch.arange(m, dtype=idx, device=out_lay.device)
    flat = lay.inv_pos.to(idx) + (rows * L)[:, None]
    return out_lay.reshape((m * L,) + tail).index_select(
        0, flat.view(-1)).view(tuple(lay.inv_pos.shape) + tail)


def _layout_to_points(lay, out_lay: torch.Tensor) -> torch.Tensor:
    """out_lay (m, L) or (m, k, L) back to point order: (m, n) or
    (m, n, k)."""
    if out_lay.ndim == 2:
        return rows_to_points(lay, out_lay)
    m, L = lay.src.shape
    idx = torch.int32 if out_lay.numel() < 2 ** 31 else torch.int64
    rows = torch.arange(m, dtype=idx, device=out_lay.device)
    k = out_lay.shape[1]
    flat = (lay.inv_pos[:, None, :] + L * (rows[:, None] * k + torch.arange(
        k, dtype=idx, device=out_lay.device))[:, :, None])
    vals = out_lay.view(-1).index_select(0, flat.view(-1)).view(flat.shape)
    return vals.transpose(1, 2)


def bin_fused_matvec_op(index: TableIndex, beta: torch.Tensor, *,
                        average: bool = True) -> torch.Tensor:
    """K~ beta off the slot-blocked layout; beta (n,) or (n, k).  On the
    card: B2's run totals, then the readout over ``inv_pos`` (mean, or sum
    when not ``average``).  On the CPU: beta laid out, the plain fused
    matvec, mapped back and combined."""
    lay = _layout(index)
    if on_card(beta, lay.slot_lay):
        totals = bin_fused_matvec_cuda(
            lay.slot_lay, lay.coeff_lay, lay.src,
            beta.to(torch.float32).contiguous(), totals=True)
        return bin_readout_cuda(lay.inv_pos, index.coeff.contiguous(),
                                totals, average=average)
    beta_lay = _beta_to_layout(lay, beta)
    out_lay = fused_matvec_ref(lay.slot_lay, lay.coeff_lay, beta_lay,
                               width=lay.num_tiles * lay.block_t)
    vals = _layout_to_points(lay, out_lay)
    return vals.mean(0) if average else vals.sum(0)


def bin_loads_blocked_op(index: TableIndex, beta: torch.Tensor) -> torch.Tensor:
    """(m, B) tables for beta (n,), or (m, B, k) for beta (n, k)."""
    lay = _layout(index)
    beta_lay = _beta_to_layout(lay, beta)
    coeff = lay.coeff_lay if beta.ndim == 1 else lay.coeff_lay[:, None, :]
    contrib = coeff * beta_lay
    if on_card(contrib, lay.slot_lay):
        tables = bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay,
                                          contrib, block_n=lay.block_n,
                                          block_t=lay.block_t)
    else:
        tables = scatter_blocked_ref(lay.slot_lay, contrib,
                                     width=lay.num_tiles * lay.block_t)
    tables = tables[..., :index.table_size]
    if beta.ndim == 2:
        tables = tables.transpose(1, 2)
    return tables.contiguous()


def bin_loads_op(index: TableIndex, beta: torch.Tensor) -> torch.Tensor:
    """(m, B[, k]) bucket-load tables: off the slot-blocked layout when the
    index carries its kernel group (B3), else the point scatter (B5)."""
    if _kernel_layout(index) is not None:
        return bin_loads_blocked_op(index, beta)
    beta = beta.to(torch.float32)
    contrib = index.coeff * beta if beta.ndim == 1 else \
        index.coeff[..., None] * beta
    if on_card(contrib, index.slot):
        return bin_scatter_cuda(index.slot, contrib.contiguous(),
                                index.table_size)
    return scatter_ref(index.slot, contrib, table_size=index.table_size)


def bin_readout_blocked_op(index: TableIndex, tables: torch.Tensor, *,
                           average: bool = True) -> torch.Tensor:
    """Readout over the slot-blocked layout (B6): gather along the layout,
    map back through ``inv_pos``, combine over the instances."""
    lay = _layout(index)
    tables = tables.to(torch.float32).contiguous()
    if on_card(lay.slot_lay, tables):
        out_lay = bin_gather_blocked_cuda(lay.slot_lay, tables)
    else:
        out_lay = gather_blocked_ref(lay.slot_lay, tables)
    return combine_ref(index.coeff, rows_to_points(lay, out_lay), average)


def bin_readout_op(index: TableIndex, tables: torch.Tensor, *,
                   average: bool = True) -> torch.Tensor:
    """Per-point readout of tables (m, B) -> (n,), or (m, B, k) -> (n, k):
    mean over the instances of coeff * tables[s, slot] (sum when not
    ``average``).  An index carrying the layout's kernel group reads over
    the layout (B6), any other through the fused per-point readout (B4)."""
    if _kernel_layout(index) is not None:
        return bin_readout_blocked_op(index, tables, average=average)
    tables = tables.to(torch.float32).contiguous()
    if on_card(index.slot, index.coeff, tables):
        return bin_readout_cuda(index.slot, index.coeff.contiguous(),
                                tables, average=average)
    return readout_ref(index.slot, index.coeff, tables, average)


def table_matvec_op(index: TableIndex, beta: torch.Tensor, *,
                    average: bool = True) -> torch.Tensor:
    """The split matvec: tables from beta, then the readout."""
    return bin_readout_op(index, bin_loads_op(index, beta), average=average)


def route_pack_op(cell_lay: torch.Tensor, contrib_lay: torch.Tensor,
                  used: torch.Tensor, cap: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Hash-join wire pack (B7): (len(used) * cap[, k]) layout-order run
    sums in f32, rounded once to ``out_dtype``; owner o's cells are
    [o*cap, o*cap + used[o])."""
    if on_card(cell_lay, contrib_lay, used):
        return route_pack_cuda(cell_lay, contrib_lay.contiguous(), used, cap,
                               out_dtype=out_dtype)
    return route_pack_ref(cell_lay, contrib_lay,
                          num_cells=used.shape[0] * cap).to(out_dtype)


def route_unpack_op(cell_lay: torch.Tensor, coeff_lay: torch.Tensor,
                    back: torch.Tensor) -> torch.Tensor:
    """Hash-join wire unpack (B8): (m, L[, k]) coeff-weighted reads."""
    if on_card(cell_lay, back):
        return route_unpack_cuda(cell_lay, coeff_lay, back.contiguous())
    return route_unpack_ref(cell_lay, coeff_lay, back)
