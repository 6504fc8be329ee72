"""The hand-written kernels on meta tensors, and each kernel's cost.

A dry run (``launch.dryrun``) runs the port's steps on meta tensors: no
storage, no card.  Each ``*_meta`` function here stands for the wrapper of
the same name in ``*/kernel.py`` (its arguments, its outputs' shapes and
dtypes, allocated with ``torch.empty`` as the wrapper allocates them) and
launches nothing.  The ops modules call it where every tensor is a meta
tensor (``backend.on_meta``); a CUDA tensor never reaches it.

Each ``*_cost`` function gives one call's (operations, bytes): the bytes
of the kernel's bound in PERF.md §6 (each input read once, each output
written once) and its float32 operations, from shapes alone, so that a
traced run on the card and a dry run credit the same
(``roofline.kernel``).  Where the bound counts what the data reaches (B3's
tiles' ranges, the distinct buckets B6 and B8 read), the cost counts the
most the shapes allow: the whole layout for B3, and for B6 and B8 the
smaller of the table and one read a position.
"""
from __future__ import annotations

import torch

META = torch.device("meta")
F32 = torch.float32


def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _empty(shape, dtype=F32):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# -- B1 -----------------------------------------------------------------------

def featurize_meta(x, w, z, r1, r2, *, f, table_size: int):
    m, n = w.shape[0], x.shape[0]
    return (_empty((m, n), torch.uint32), _empty((m, n), torch.uint32),
            _empty((m, n)), _empty((m, n)), _empty((m, n), torch.int32),
            _empty((m, n)))


def featurize_cost(x, w):
    """x (n, d), w (m, d): x, w, z, r1 and r2 read, six (m, n) outputs of
    4 bytes written; 5 operations a (instance, point, coordinate)."""
    (n, d), m = x.shape, w.shape[0]
    return 5.0 * m * n * d, _nb(x) + 4 * _nb(w) + 24 * m * n


# -- B2, B3, B4, B5, B6 ---------------------------------------------------------

def bin_fused_matvec_meta(slot_lay, coeff_lay, src, beta, *,
                          totals: bool = False):
    m, L = slot_lay.shape
    tail = tuple(beta.shape[1:])
    return _empty(((m, L) + tail) if totals else ((m,) + tail + (L,)))


def bin_fused_matvec_cost(slot_lay, beta):
    """slot, coeff and src (m, L) and beta read once, the (m, L[, k])
    totals written once; a multiply and an add a position and column."""
    m, L = slot_lay.shape
    k = beta.shape[1] if beta.ndim == 2 else 1
    out = 4 * m * L * k
    return 2.0 * m * L * k, 3 * _nb(slot_lay) + _nb(beta) + out


def bin_scatter_blocked_meta(blk_start, slot_lay, contrib_lay, *,
                             block_n: int, block_t: int):
    m = slot_lay.shape[0]
    width = (blk_start.shape[1] - 1) * block_t
    if contrib_lay.ndim == 3:
        return _empty((m, contrib_lay.shape[1], width))
    return _empty((m, width))


def bin_scatter_blocked_cost(blk_start, slot_lay, contrib_lay, block_t: int):
    """blk_start, slot and contrib over the whole layout read, the tables
    written; an add a contribution."""
    m = slot_lay.shape[0]
    k = contrib_lay.shape[1] if contrib_lay.ndim == 3 else 1
    tables = 4 * m * k * (blk_start.shape[1] - 1) * block_t
    return (float(contrib_lay.numel()),
            _nb(blk_start, slot_lay, contrib_lay) + tables)


def bin_readout_meta(slot, coeff, tables, *, average: bool = True):
    return _empty((coeff.shape[1],) + tuple(tables.shape[2:]))


def bin_readout_cost(slot, coeff, tables):
    """slot and coeff read, one table value a (instance, point) read (the
    values themselves where ``slot`` is None), the (n[, k]) output written;
    a multiply and an add a value."""
    m, n = coeff.shape
    k = tables.shape[2] if tables.ndim == 3 else 1
    reads = _nb(tables) if slot is None else 4 * k * m * n
    return 2.0 * k * m * n, _nb(slot, coeff) + reads + 4 * n * k


def bin_scatter_meta(slot, contrib, table_size: int):
    return _empty((slot.shape[0], int(table_size)) + tuple(contrib.shape[2:]))


def bin_scatter_cost(slot, contrib, table_size: int):
    """slot and contrib read, the (m, B[, k]) tables written; an add a
    contribution."""
    k = contrib.shape[2] if contrib.ndim == 3 else 1
    return (float(contrib.numel()),
            _nb(slot, contrib) + 4 * slot.shape[0] * int(table_size) * k)


def bin_gather_blocked_meta(slot_lay, tables):
    return _empty(tuple(slot_lay.shape) + tuple(tables.shape[2:]))


def bin_gather_blocked_cost(slot_lay, tables):
    """slot_lay read, the (m, L[, k]) output written, and the buckets read:
    at most the table, at most one a position."""
    k = tables.shape[2] if tables.ndim == 3 else 1
    out = 4 * slot_lay.numel() * k
    return 0.0, _nb(slot_lay) + out + min(_nb(tables), out)


# -- B7, B8 -----------------------------------------------------------------------

def route_pack_meta(cell_lay, contrib_lay, used, cap: int, *,
                    out_dtype=F32):
    return _empty((used.shape[0] * int(cap),) + tuple(contrib_lay.shape[2:]),
                  out_dtype)


def route_pack_cost(cell_lay, contrib_lay, used, cap: int, out_dtype):
    """cell and contrib read, the wire buffer written in its dtype; an add
    a contribution."""
    k = contrib_lay.shape[2] if contrib_lay.ndim == 3 else 1
    send = used.shape[0] * int(cap) * k * torch.empty(
        (), dtype=out_dtype).element_size()
    return float(contrib_lay.numel()), _nb(cell_lay, contrib_lay) + send


def route_unpack_meta(cell_lay, coeff_lay, back):
    return _empty(tuple(cell_lay.shape) + tuple(back.shape[1:]))


def route_unpack_cost(cell_lay, coeff_lay, back):
    """cell (and coeff) read, the (m, L[, k]) output written, and the
    received cells read: at most all of them, at most one a position; a
    multiply a value with the coefficient."""
    k = back.shape[1] if back.ndim == 2 else 1
    out = 4 * cell_lay.numel() * k
    ops = 0.0 if coeff_lay is None else float(cell_lay.numel() * k)
    return ops, _nb(cell_lay, coeff_lay) + out + min(_nb(back), out)


# -- B9 -----------------------------------------------------------------------

def flash_decode_meta(q, k, v, valid, softcap: float = 0.0):
    return _empty(q.shape)


def flash_decode_cost(q, k, v, valid):
    """q, the k and v caches and valid read once, the (B, KV, G, D) output
    written; 4 operations a (query element, cache row)."""
    return (4.0 * q.numel() * k.shape[1],
            _nb(q, k, v, valid) + 4 * q.numel())
