"""Plain PyTorch versions of the binning kernels, on the same arrays and at
the same boundaries as the CUDA kernels (csrc/binning.cu).  Sums go through
``index_add_``."""
from __future__ import annotations

import torch


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


def gather_ref(slot, tables):
    """out[s, i(, j)] = tables[s, slot[s, i](, j)] for tables (m, B[, k])."""
    rows = torch.arange(slot.shape[0], device=slot.device)[:, None]
    return tables[rows, slot.long()]
