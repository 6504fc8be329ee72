"""Plain PyTorch versions of the binning kernels, on the same arrays and at
the same boundaries as the CUDA kernels (csrc/binning.cu).  Sums go through
``index_add_``.  The readout's (``readout_ref``, and ``combine_ref`` after
a gather) is the plain one of ``core.wlsh``, so the port keeps one."""
from __future__ import annotations

import torch

from ...core.wlsh import combine_instances as combine_ref
from ...core.wlsh import point_readout as readout_ref


def _flat_slots(slot_lay: torch.Tensor, k: int, width: int) -> torch.Tensor:
    """(m, k, L) flat table index (s*k + j)*width + slot for each column."""
    m = slot_lay.shape[0]
    rows = torch.arange(m * k, device=slot_lay.device).view(m, k, 1)
    return (slot_lay.long()[:, None, :] + width * rows)


def scatter_blocked_ref(slot_lay, contrib_lay, *, width: int):
    """tables[s, (j,) b] = sum_{p: slot_lay[s, p] = b} contrib_lay[s, (j,) p]
    for slot_lay (m, L) and contrib_lay (m, L) or (m, k, L); tables are
    (m, width) or (m, k, width)."""
    multi = contrib_lay.ndim == 3
    c = contrib_lay if multi else contrib_lay[:, None, :]
    m, k, _ = c.shape
    tables = torch.zeros(m * k * width, dtype=torch.float32,
                         device=c.device)
    tables.index_add_(0, _flat_slots(slot_lay, k, width).reshape(-1),
                      c.reshape(-1).to(torch.float32))
    tables = tables.view(m, k, width)
    return tables if multi else tables[:, 0]


def fused_matvec_ref(slot_lay, coeff_lay, beta_lay, *, width: int):
    """out[s, (j,) p] = coeff[s, p] * sum_{q: slot[s,q] = slot[s,p]}
    coeff[s, q] * beta[s, (j,) q]; beta_lay (m, L) or (m, k, L)."""
    multi = beta_lay.ndim == 3
    coeff = coeff_lay if not multi else coeff_lay[:, None, :]
    tables = scatter_blocked_ref(slot_lay, coeff * beta_lay, width=width)
    t = tables if multi else tables[:, None, :]
    m, k, _ = t.shape
    flat = _flat_slots(slot_lay, k, width)
    vals = t.reshape(-1)[flat.reshape(-1)].view(flat.shape)
    return coeff * (vals if multi else vals[:, 0])


def fused_matvec_src_ref(slot_lay, coeff_lay, src, beta, *,
                         totals: bool = False):
    """The plain version of ``bin_fused_matvec_cuda``: beta (n,) or (n, k)
    read in point order through src (m, L) (n at padding).  T[s, p(, j)] =
    table[s, slot_lay[s, p](, j)] summed from coeff_lay * beta at the real
    positions, 0 at padding; returns T, (m, L) or (m, L, k), when
    ``totals``, else coeff_lay * T as (m, L) or (m, k, L)."""
    m, L = slot_lay.shape
    n, tail = beta.shape[0], tuple(beta.shape[1:])
    pad = torch.zeros((1,) + tail, dtype=torch.float32, device=beta.device)
    beta_lay = torch.cat([beta.to(torch.float32), pad]).index_select(
        0, src.reshape(-1).long()).view((m, L) + tail)
    coeff = coeff_lay if not tail else coeff_lay[..., None]
    width = int(slot_lay.max()) + 1 if slot_lay.numel() else 1
    flat = (slot_lay.long() + width * torch.arange(
        m, device=slot_lay.device)[:, None]).view(-1)
    tables = torch.zeros((m * width,) + tail, dtype=torch.float32,
                         device=slot_lay.device)
    tables.index_add_(0, flat, (coeff * beta_lay).reshape((-1,) + tail))
    real = (src < n).view((m, L) + (1,) * len(tail))
    t = torch.where(real, tables[flat].view((m, L) + tail), 0.0)
    if totals:
        return t
    out = coeff * t
    return out if not tail else out.transpose(1, 2).contiguous()


def gather_ref(slot, tables):
    """out[s, i(, j)] = tables[s, slot[s, i](, j)] for tables (m, B[, k])."""
    rows = torch.arange(slot.shape[0], device=slot.device)[:, None]
    return tables[rows, slot.long()]


def scatter_ref(slot, contrib, *, table_size: int):
    """tables[s, b(, j)] = sum_{i: slot[s, i] = b} contrib[s, i(, j)] for
    slot (m, n) and contrib (m, n) or (m, n, k) -> (m, B) or (m, B, k)."""
    m, n = slot.shape
    tail = tuple(contrib.shape[2:])
    flat = slot.long() + table_size * torch.arange(m, device=slot.device
                                                   )[:, None]
    tables = torch.zeros((m * table_size,) + tail, dtype=torch.float32,
                         device=slot.device)
    tables.index_add_(0, flat.reshape(-1),
                      contrib.reshape((m * n,) + tail).to(torch.float32))
    return tables.view((m, table_size) + tail)


def gather_blocked_ref(slot_lay, tables):
    """out_lay[s, p(, j)] = tables[s, slot_lay[s, p](, j)]."""
    return gather_ref(slot_lay, tables)


def route_pack_ref(cell_lay, contrib_lay, *, num_cells: int):
    """send[c(, j)] = the layout-order sum of contrib_lay[s, p(, j)] over
    the run of positions with cell_lay[s, p] = c (cells >= num_cells are
    skipped; unreached cells are 0).  Sums run head first, one addition
    per run position, as the CUDA kernel adds them, so the two agree bit
    for bit."""
    m, L = cell_lay.shape
    tail = tuple(contrib_lay.shape[2:])
    cell = cell_lay.long()
    real = (cell >= 0) & (cell < num_cells)
    head = real.clone()
    head[:, 1:] &= cell[:, 1:] != cell[:, :-1]
    starts = head.view(-1).nonzero()[:, 0]
    # run length: real positions up to the next head (runs are contiguous)
    run_of = torch.cumsum(head.view(-1), 0) - 1
    lengths = torch.bincount(run_of[real.view(-1)],
                             minlength=starts.numel())
    vals = contrib_lay.reshape((m * L,) + tail)
    acc = torch.zeros((starts.numel(),) + tail, dtype=torch.float32,
                      device=cell_lay.device)
    r = 0
    live = torch.arange(starts.numel(), device=cell_lay.device)
    while live.numel():
        acc[live] = acc[live] + vals[starts[live] + r]
        r += 1
        live = live[lengths[live] > r]
    send = torch.zeros((num_cells,) + tail, dtype=torch.float32,
                       device=cell_lay.device)
    send[cell.view(-1)[starts]] = acc
    return send


def route_unpack_ref(cell_lay, coeff_lay, back):
    """out_lay[s, p(, j)] = coeff_lay[s, p] * back[cell_lay[s, p](, j)],
    with sentinel cells (>= len(back)) reading 0; coeff_lay None reads the
    values unscaled."""
    num_cells = back.shape[0]
    cell = cell_lay.long()
    idx = torch.where((cell >= 0) & (cell < num_cells), cell, num_cells)
    pad = torch.zeros((1,) + tuple(back.shape[1:]), dtype=back.dtype,
                      device=back.device)
    vals = torch.cat([back, pad])[idx]
    if coeff_lay is None:
        return vals
    return (coeff_lay if back.ndim == 1 else coeff_lay[..., None]) * vals
