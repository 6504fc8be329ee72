"""Wrappers of the yardsticks in csrc/scatter_variants.cu, the first
designs of B5, B7 and B2, timed beside them in ``chip_smoke.py`` phase 5
and on no path of the port, so not counted."""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load, stream_ptr
from .kernel import (_layout_args, _need, _pack_args, _scatter_args,
                     _tables)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = load("scatter_variants")
    if lib.bin_scatter_v1_launch.argtypes is None:
        lib.bin_scatter_v1_launch.argtypes = [_P] * 3 + [_I, _L, _L, _I, _P]
        lib.route_pack_v1_launch.argtypes = [_P] * 3 + [_I, _L, _L, _I, _P]
        lib.fused_matvec_v1_launch.argtypes = [_P] * 5 + [_I] * 4 + [
            _L, _I, _I, _P]
        for fn in (lib.bin_scatter_v1_launch, lib.route_pack_v1_launch,
                   lib.fused_matvec_v1_launch):
            fn.restype = _I
        lib.scatter_variants_error_string.argtypes = [_I]
        lib.scatter_variants_error_string.restype = ctypes.c_char_p
    return lib


def bin_scatter_v1_cuda(slot, contrib, table_size: int):
    """B5's first design: a memset of the whole table, then one global
    atomic per point and column."""
    m, n, k = _scatter_args(slot, contrib, table_size)
    tables = _tables(slot, contrib, table_size)
    if tables.numel() == 0:
        return tables
    lib = _lib()
    rc = lib.bin_scatter_v1_launch(slot.data_ptr(), contrib.data_ptr(),
                                   tables.data_ptr(), m, n, int(table_size),
                                   k, stream_ptr(tables.device))
    check(rc, "bin_scatter_v1", lib.scatter_variants_error_string)
    return tables


def route_pack_v1_cuda(cell_lay, contrib_lay, num_cells: int):
    """B7's first design: a memset of the whole send buffer, then a
    run-head walk per thread and column; f32 only."""
    m, L, k = _pack_args(cell_lay, contrib_lay, num_cells)
    send = torch.empty((int(num_cells),) + tuple(contrib_lay.shape[2:]),
                       dtype=torch.float32, device=cell_lay.device)
    if send.numel() == 0:
        return send
    lib = _lib()
    rc = lib.route_pack_v1_launch(cell_lay.data_ptr(),
                                  contrib_lay.data_ptr(), send.data_ptr(),
                                  m, L, int(num_cells), k,
                                  stream_ptr(send.device))
    check(rc, "route_pack_v1", lib.scatter_variants_error_string)
    return send


def fused_matvec_v1_cuda(blk_start, slot_lay, coeff_lay, beta_lay, *,
                         block_n: int, block_t: int):
    """B2's first design, in the contract form: out_lay[s, (j,) p] =
    coeff_lay[s, p] * table[s, (j,) slot_lay[s, p]], the table summed from
    coeff_lay * beta_lay (m, L) or (m, k, L), beta laid out beforehand; a
    block per (instance, tile), shared-memory float atomics."""
    k = beta_lay.shape[1] if beta_lay.ndim == 3 else 1
    m, L, num_tiles, kc = _layout_args(blk_start, slot_lay, block_n,
                                       block_t, k)
    _need(coeff_lay, "coeff_lay", torch.float32, (m, L))
    _need(beta_lay, "beta_lay", torch.float32,
          (m, k, L) if beta_lay.ndim == 3 else (m, L))
    out = torch.empty_like(beta_lay)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.fused_matvec_v1_launch(
        blk_start.data_ptr(), slot_lay.data_ptr(), coeff_lay.data_ptr(),
        beta_lay.data_ptr(), out.data_ptr(), m, num_tiles, block_n, block_t,
        L, k, kc, stream_ptr(out.device))
    check(rc, "fused_matvec_v1", lib.scatter_variants_error_string)
    return out
