"""Public ops: the CountSketch matvec, table build and readout on the
binning kernels, dispatched on the device of the index (the CUDA kernels on
the card, their plain versions on the CPU).

* ``bin_fused_matvec_op``  ~ ``table_matvec_fused`` — one kernel over the
  slot-blocked layout; the (m, B) table exists only as shared-memory tiles.
* ``bin_loads_blocked_op`` ~ ``table_loads`` — the (m, B[, k]) prediction
  tables from the same layout.
* ``bin_readout_op``       ~ ``table_readout`` — gather each point's bucket
  load and combine over the instances.

Around the kernels, beta is laid out through ``src`` and results map back
through ``inv_pos`` with PyTorch indexing (int32 indices, no int64 copies).
"""
from __future__ import annotations

import torch

from ...backend import on_card
from ...core.wlsh import TableIndex
from .kernel import (bin_fused_matvec_cuda, bin_gather_cuda,
                     bin_scatter_blocked_cuda)
from .ref import fused_matvec_ref, gather_ref, scatter_blocked_ref


def _layout(index: TableIndex):
    lay = index.blocked
    if lay is None or lay.blk_start is None:
        raise ValueError("needs a slot-blocked index with the kernel group; "
                         "build it with build_blocked_layout(parts='kernel'|"
                         "'both') / op.build_index(feats, blocked=True)")
    return lay


def _beta_to_layout(lay, beta: torch.Tensor) -> torch.Tensor:
    """beta (n,) or (n, k) laid out along the slot permutation: (m, L) or
    (m, k, L); padding positions read an appended zero row."""
    m, L = lay.src.shape
    pad = torch.zeros((1,) + tuple(beta.shape[1:]), dtype=torch.float32,
                      device=beta.device)
    beta_pad = torch.cat([beta.to(torch.float32), pad])
    lay_vals = beta_pad.index_select(0, lay.src.view(-1))
    if beta.ndim == 1:
        return lay_vals.view(m, L)
    return lay_vals.view(m, L, -1).transpose(1, 2).contiguous()


def _layout_to_points(lay, out_lay: torch.Tensor) -> torch.Tensor:
    """out_lay (m, L) or (m, k, L) back to point order: (m, n) or
    (m, n, k)."""
    m, L = lay.src.shape
    idx = torch.int32 if out_lay.numel() < 2 ** 31 else torch.int64
    rows = torch.arange(m, dtype=idx, device=out_lay.device)
    if out_lay.ndim == 2:
        flat = lay.inv_pos + (rows * L)[:, None]
        return out_lay.view(-1).index_select(0, flat.view(-1)).view(
            lay.inv_pos.shape)
    k = out_lay.shape[1]
    flat = (lay.inv_pos[:, None, :] + L * (rows[:, None] * k + torch.arange(
        k, dtype=idx, device=out_lay.device))[:, :, None])
    vals = out_lay.view(-1).index_select(0, flat.view(-1)).view(flat.shape)
    return vals.transpose(1, 2)


def bin_fused_matvec_op(index: TableIndex, beta: torch.Tensor, *,
                        average: bool = True) -> torch.Tensor:
    """K~ beta off the slot-blocked layout; beta (n,) or (n, k)."""
    lay = _layout(index)
    beta_lay = _beta_to_layout(lay, beta)
    if on_card(beta_lay, lay.slot_lay):
        out_lay = bin_fused_matvec_cuda(lay.blk_start, lay.slot_lay,
                                        lay.coeff_lay, beta_lay,
                                        block_n=lay.block_n,
                                        block_t=lay.block_t)
    else:
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


def bin_readout_op(index: TableIndex, tables: torch.Tensor, *,
                   average: bool = True) -> torch.Tensor:
    """Per-point readout of tables (m, B) -> (n,), or (m, B, k) -> (n, k):
    mean over the instances of coeff * tables[s, slot] (sum when not
    ``average``)."""
    tables = tables.to(torch.float32).contiguous()
    if on_card(index.slot, tables):
        vals = bin_gather_cuda(index.slot, tables)
    else:
        vals = gather_ref(index.slot, tables)
    signed = index.coeff * vals if vals.ndim == 2 else \
        index.coeff[..., None] * vals
    return signed.mean(0) if average else signed.sum(0)
