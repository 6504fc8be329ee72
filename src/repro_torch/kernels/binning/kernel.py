"""Wrappers of the CUDA binning kernels (csrc/binning.cu), which replace the
TPU kernels ``bin_fused_matvec_pallas``, ``bin_scatter_blocked_pallas`` and
``bin_gather_pallas``.  Each checks its arguments, allocates its output with
``torch.empty``, launches on the current stream, raises on a launch error
and counts its launches in ``<wrapper>.launches``."""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SMEM = 48 * 1024      # shared tile budget without an opt-in


def _lib():
    lib = load("binning")
    if lib.bin_gather_launch.argtypes is None:
        lib.bin_fused_matvec_launch.argtypes = [_P] * 5 + [_I] * 4 + [
            _L, _I, _I, _P]
        lib.bin_scatter_blocked_launch.argtypes = [_P] * 4 + [_I] * 4 + [
            _L, _I, _I, _P]
        lib.bin_gather_launch.argtypes = [_P] * 3 + [_I, _I, _L, _I, _P]
        for fn in (lib.bin_fused_matvec_launch,
                   lib.bin_scatter_blocked_launch, lib.bin_gather_launch):
            fn.restype = _I
        lib.binning_error_string.argtypes = [_I]
        lib.binning_error_string.restype = ctypes.c_char_p
    return lib


def _need(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor"
                         + (f" of shape {tuple(shape)}" if shape else "")
                         + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _layout_args(blk_start, slot_lay, block_n, block_t, cols):
    m, L = slot_lay.shape
    num_tiles = blk_start.shape[1] - 1
    _need(blk_start, "blk_start", torch.int32, (m, num_tiles + 1))
    _need(slot_lay, "slot_lay", torch.int32, (m, L))
    if L % block_n or m > 65535 or num_tiles >= 2 ** 31 - 1:
        raise ValueError(f"layout (m={m}, L={L}) does not fit the kernel "
                         f"geometry (block_n={block_n})")
    kc = min(cols, _SMEM // (4 * block_t))
    if kc < 1:
        raise ValueError(f"block_t={block_t} tile exceeds shared memory")
    return m, L, num_tiles, kc


def bin_fused_matvec_cuda(blk_start, slot_lay, coeff_lay, beta_lay, *,
                          block_n: int, block_t: int):
    """out_lay[s, (j,) p] = coeff_lay[s, p] * table[s, (j,) slot_lay[s, p]]
    with the table summed from coeff_lay * beta_lay over the layout;
    beta_lay (m, L) or (m, k, L) f32.  Padding positions come out 0."""
    k = beta_lay.shape[1] if beta_lay.ndim == 3 else 1
    m, L, num_tiles, kc = _layout_args(blk_start, slot_lay, block_n,
                                       block_t, k)
    _need(coeff_lay, "coeff_lay", torch.float32, (m, L))
    _need(beta_lay, "beta_lay", torch.float32,
          (m, k, L) if beta_lay.ndim == 3 else (m, L))
    out = torch.empty_like(beta_lay)
    if m == 0 or L == 0 or k == 0:
        return out
    lib = _lib()
    bin_fused_matvec_cuda.launches += 1
    rc = lib.bin_fused_matvec_launch(
        blk_start.data_ptr(), slot_lay.data_ptr(), coeff_lay.data_ptr(),
        beta_lay.data_ptr(), out.data_ptr(), m, num_tiles, block_n, block_t,
        L, k, kc, stream_ptr(out.device))
    check(rc, "bin_fused_matvec", lib.binning_error_string)
    return out


def bin_scatter_blocked_cuda(blk_start, slot_lay, contrib_lay, *,
                             block_n: int, block_t: int):
    """tables[s, (j,) b] = sum_{p: slot_lay[s, p] = b} contrib_lay[s, (j,) p]
    -> (m, T*bt) or (m, k, T*bt) f32; every tile written, empty ones 0."""
    k = contrib_lay.shape[1] if contrib_lay.ndim == 3 else 1
    m, L, num_tiles, kc = _layout_args(blk_start, slot_lay, block_n,
                                       block_t, k)
    _need(contrib_lay, "contrib_lay", torch.float32,
          (m, k, L) if contrib_lay.ndim == 3 else (m, L))
    width = num_tiles * block_t
    shape = (m, k, width) if contrib_lay.ndim == 3 else (m, width)
    tables = torch.empty(shape, dtype=torch.float32, device=slot_lay.device)
    if tables.numel() == 0:
        return tables
    lib = _lib()
    bin_scatter_blocked_cuda.launches += 1
    rc = lib.bin_scatter_blocked_launch(
        blk_start.data_ptr(), slot_lay.data_ptr(), contrib_lay.data_ptr(),
        tables.data_ptr(), m, num_tiles, block_n, block_t, L, k, kc,
        stream_ptr(tables.device))
    check(rc, "bin_scatter_blocked", lib.binning_error_string)
    return tables


def bin_gather_cuda(slot, tables):
    """out[s, i(, j)] = tables[s, slot[s, i](, j)]; slot (m, n) int32 in
    [0, B), tables (m, B) or (m, B, k) f32."""
    m, n = slot.shape
    _need(slot, "slot", torch.int32, (m, n))
    _need(tables, "tables", torch.float32)
    if tables.ndim not in (2, 3) or tables.shape[0] != m:
        raise ValueError(f"tables must be (m={m}, B[, k]), got "
                         f"{tuple(tables.shape)}")
    B = tables.shape[1]
    k = tables.shape[2] if tables.ndim == 3 else 1
    if m > 65535 or n * k >= 2 ** 31:
        raise ValueError(f"gather: m={m}, n*k={n * k} out of range")
    out = torch.empty((m, n) + tuple(tables.shape[2:]), dtype=torch.float32,
                      device=slot.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    bin_gather_cuda.launches += 1
    rc = lib.bin_gather_launch(slot.data_ptr(), tables.data_ptr(),
                               out.data_ptr(), m, n, B, k,
                               stream_ptr(out.device))
    check(rc, "bin_gather", lib.binning_error_string)
    return out


bin_fused_matvec_cuda.launches = 0
bin_scatter_blocked_cuda.launches = 0
bin_gather_cuda.launches = 0
