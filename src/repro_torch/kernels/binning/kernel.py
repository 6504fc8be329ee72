"""Wrappers of the CUDA binning kernels (csrc/binning.cu) and route kernels
(csrc/route.cu), which replace the TPU kernels ``bin_fused_matvec_pallas``,
``bin_scatter_blocked_pallas``, ``bin_gather_pallas`` (in its contract form,
and fused with the readout's combine), ``bin_scatter_pallas``,
``bin_gather_blocked_pallas``, ``route_pack_pallas`` and
``route_unpack_pallas``.  Each checks its arguments, allocates its output
with ``torch.empty``, launches on the current stream, raises on a launch
error and counts its launches in ``<wrapper>.launches`` and, by input
shape, in ``<wrapper>.launches_by_shape``."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import check, count_launch, dtype_name, load, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SMEM = 48 * 1024      # shared tile budget without an opt-in


def _lib():
    lib = load("binning")
    if lib.bin_gather_launch.argtypes is None:
        lib.bin_fused_matvec_launch.argtypes = [_P] * 5 + [
            _I, _L, _I, _I, _I, _P, _P]
        lib.bin_fused_matvec_scratch.argtypes = [_I, _L, _I]
        lib.bin_fused_matvec_scratch.restype = _L
        lib.bin_scatter_blocked_launch.argtypes = [_P] * 4 + [_I] * 4 + [
            _L, _I, _P]
        lib.bin_gather_launch.argtypes = [_P] * 3 + [_I, _I, _L, _I, _P]
        lib.bin_readout_launch.argtypes = [_P] * 4 + [
            _I, _L, _L, _I, _I, ctypes.c_float, _P]
        lib.bin_gather_blocked_launch.argtypes = [_P] * 3 + [
            _I, _I, _L, _I, _P]
        lib.bin_scatter_launch.argtypes = [_P] * 3 + [
            _I, _L, _L] + [_I] * 7 + [_P] * 6
        for fn in (lib.bin_fused_matvec_launch,
                   lib.bin_scatter_blocked_launch, lib.bin_gather_launch,
                   lib.bin_readout_launch, lib.bin_gather_blocked_launch,
                   lib.bin_scatter_launch):
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


def bin_fused_matvec_cuda(slot_lay, coeff_lay, src, beta, *,
                          totals: bool = False):
    """The CountSketch matvec over the slot-blocked layout, reading beta
    (n,) or (n, k) f32 in point order through ``src`` (m, L) (n at
    padding).  T[s, p(, j)] is the sum of coeff_lay[s, q] * beta[src[s, q]
    (, j)] over the run of equal slots holding p (padding: 0).  Returns T,
    (m, L) or (m, L, k), when ``totals`` (what the readout takes), else the
    contract form coeff_lay * T, (m, L) or (m, k, L).  The runs are summed
    over fixed-size chunks in a fixed order: the same bits from launch to
    launch, equal to ``testing.matvec_model``'s."""
    m, L = slot_lay.shape
    _need(slot_lay, "slot_lay", torch.int32, (m, L))
    _need(coeff_lay, "coeff_lay", torch.float32, (m, L))
    _need(src, "src", torch.int32, (m, L))
    _need(beta, "beta", torch.float32)
    if beta.ndim not in (1, 2):
        raise ValueError(f"beta must be (n,) or (n, k), got "
                         f"{tuple(beta.shape)}")
    n, k = beta.shape[0], beta.shape[1] if beta.ndim == 2 else 1
    if L % 4 or m > 65535 or n >= 2 ** 31 or any(
            t.data_ptr() % 16 for t in (slot_lay, coeff_lay, src)):
        raise ValueError(f"fused matvec: needs L % 4 == 0 (L={L}), m <= "
                         f"65535 (m={m}), n < 2^31 and 16-byte aligned rows")
    tail = () if beta.ndim == 1 else (k,)
    shape = ((m, L) + tail) if totals else ((m,) + tail + (L,))
    out = torch.empty(shape, dtype=torch.float32, device=slot_lay.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    scratch = torch.empty(int(lib.bin_fused_matvec_scratch(m, L, k)),
                          dtype=torch.uint8, device=slot_lay.device)
    count_launch(bin_fused_matvec_cuda, (m, L, n, k, bool(totals)))
    rc = lib.bin_fused_matvec_launch(
        slot_lay.data_ptr(), coeff_lay.data_ptr(), src.data_ptr(),
        beta.data_ptr(), out.data_ptr(), m, L, n, k, int(bool(totals)),
        scratch.data_ptr(), stream_ptr(out.device))
    check(rc, "bin_fused_matvec", lib.binning_error_string)
    return out


def bin_scatter_blocked_cuda(blk_start, slot_lay, contrib_lay, *,
                             block_n: int, block_t: int):
    """tables[s, (j,) b] = sum_{p: slot_lay[s, p] = b} contrib_lay[s, (j,) p]
    -> (m, T*bt) or (m, k, T*bt) f32; every tile written, empty ones 0.
    Each run of equal slots is summed in a fixed order (the same bits from
    launch to launch); a tile's points end at its first slot below its
    predecessor's (the padding)."""
    k = contrib_lay.shape[1] if contrib_lay.ndim == 3 else 1
    m, L, num_tiles, _ = _layout_args(blk_start, slot_lay, block_n,
                                      block_t, k)
    _need(contrib_lay, "contrib_lay", torch.float32,
          (m, k, L) if contrib_lay.ndim == 3 else (m, L))
    width = num_tiles * block_t
    shape = (m, k, width) if contrib_lay.ndim == 3 else (m, width)
    tables = torch.empty(shape, dtype=torch.float32, device=slot_lay.device)
    if tables.numel() == 0:
        return tables
    lib = _lib()
    count_launch(bin_scatter_blocked_cuda, (m, L, k))
    rc = lib.bin_scatter_blocked_launch(
        blk_start.data_ptr(), slot_lay.data_ptr(), contrib_lay.data_ptr(),
        tables.data_ptr(), m, num_tiles, block_n, block_t, L, k,
        stream_ptr(tables.device))
    check(rc, "bin_scatter_blocked", lib.binning_error_string)
    return tables


def _gather_args(slot, tables, what):
    m, n = slot.shape
    _need(slot, what, torch.int32, (m, n))
    _need(tables, "tables", torch.float32)
    if tables.ndim not in (2, 3) or tables.shape[0] != m:
        raise ValueError(f"tables must be (m={m}, B[, k]), got "
                         f"{tuple(tables.shape)}")
    k = tables.shape[2] if tables.ndim == 3 else 1
    if m > 65535 or n * k >= 2 ** 31:
        raise ValueError(f"gather: m={m}, n*k={n * k} out of range")
    return m, n, tables.shape[1], k


def _gather_out(slot, tables):
    return torch.empty(tuple(slot.shape) + tuple(tables.shape[2:]),
                       dtype=torch.float32, device=slot.device)


def bin_gather_cuda(slot, tables):
    """out[s, i(, j)] = tables[s, slot[s, i](, j)]; slot (m, n) int32 in
    [0, B), tables (m, B) or (m, B, k) f32."""
    m, n, B, k = _gather_args(slot, tables, "slot")
    out = _gather_out(slot, tables)
    if out.numel() == 0:
        return out
    lib = _lib()
    count_launch(bin_gather_cuda, (m, n, B, k))
    rc = lib.bin_gather_launch(slot.data_ptr(), tables.data_ptr(),
                               out.data_ptr(), m, n, B, k,
                               stream_ptr(out.device))
    check(rc, "bin_gather", lib.binning_error_string)
    return out


def bin_gather_blocked_cuda(slot_lay, tables):
    """out_lay[s, p(, j)] = tables[s, slot_lay[s, p](, j)] over the
    slot-blocked layout; slot_lay (m, L) int32 in [0, B) (padding reads
    slot 0), tables (m, B) or (m, B, k) f32 -> (m, L) or (m, L, k)."""
    m, L, B, k = _gather_args(slot_lay, tables, "slot_lay")
    out = _gather_out(slot_lay, tables)
    if out.numel() == 0:
        return out
    lib = _lib()
    count_launch(bin_gather_blocked_cuda, (m, L, B, k))
    rc = lib.bin_gather_blocked_launch(slot_lay.data_ptr(), tables.data_ptr(),
                                       out.data_ptr(), m, L, B, k,
                                       stream_ptr(out.device))
    check(rc, "bin_gather_blocked", lib.binning_error_string)
    return out


# the readout keeps one instance's table in L2 for all the points (a launch
# per group of instances that fits half the L2) when its points read each
# table sector at least this often and one table fits the L2; else it adds
# READOUT_GROUP instances a launch (the fastest of 1, 4, 16 and 64 at
# predict's shape, m 64, n 2^18, B 2^23, on an H100: chip_smoke.py phase 5,
# PERF.md)
READOUT_MIN_READS_PER_SECTOR = 2.0
READOUT_GROUP = 16


def readout_group(m: int, n: int, table_size: int, k: int,
                  l2_bytes: int) -> int:
    """Instances a launch of the readout adds: one instance's table kept in
    L2 (as many as fit half of it, at least one) when the n points read
    each 32-byte sector of a table READOUT_MIN_READS_PER_SECTOR times or
    more on average and that table fits in ``l2_bytes``; else
    READOUT_GROUP.  Never more than m."""
    table_bytes = 4 * max(1, table_size) * max(1, k)
    reads_per_sector = 8 * n / max(1, table_size)   # a point reads one row
    if reads_per_sector < READOUT_MIN_READS_PER_SECTOR or \
            table_bytes > l2_bytes:
        return max(1, min(m, READOUT_GROUP))
    return max(1, min(m, l2_bytes // 2 // table_bytes))


@functools.lru_cache(maxsize=None)
def _l2_bytes(device) -> int:
    """The card's L2 size (asked once: the query costs host time a call)."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def bin_readout_cuda(slot, coeff, tables, *, average: bool = True):
    """out[i(, j)] = mean over s (sum when not ``average``) of coeff[s, i] *
    tables[s, slot[s, i](, j)]: the gather of ``bin_gather_cuda`` with the
    readout's combine fused in.  slot (m, n) int32 in [0, B), coeff (m, n)
    f32, tables (m, B) or (m, B, k) f32 -> (n,) or (n, k).  The instances
    are added in order, one fma each (the same bits from launch to launch),
    ``readout_group``'s count of them a launch."""
    m, n, B, k = _gather_args(slot, tables, "slot")
    _need(coeff, "coeff", torch.float32, (m, n))
    if m < 1:
        raise ValueError("readout: needs at least one instance")
    return _readout_launch(slot, coeff, tables, average, readout_group(
        m, n, B, k, _l2_bytes(slot.device)))


def _readout_launch(slot, coeff, tables, average: bool, group: int):
    """One launch of the readout on checked inputs, ``group`` instances
    added a launch (any grouping gives the same bits)."""
    m, n = slot.shape
    B, k = tables.shape[1], tables.shape[2] if tables.ndim == 3 else 1
    out = torch.empty((n,) + tuple(tables.shape[2:]), dtype=torch.float32,
                      device=slot.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    count_launch(bin_readout_cuda, (m, n, B, k))
    rc = lib.bin_readout_launch(slot.data_ptr(), coeff.data_ptr(),
                                tables.data_ptr(), out.data_ptr(), m, n, B, k,
                                int(group), float(m if average else 1),
                                stream_ptr(out.device))
    check(rc, "bin_readout", lib.binning_error_string)
    return out


class ScatterPlan(NamedTuple):
    """B5's cut of the work (csrc/binning.cu, bin_scatter)."""

    tile_slots: int   # W: slots of one bin, its shared tile W*cols floats
    bins: int         # ceil(B / W) bins per instance
    window: int       # bins one pass takes: a pass per window of bins
    cols: int         # columns one pass takes: a pass per group of columns
    chunk: int        # C: points a partition block stages
    group: int        # G: instances partitioned at a time
    threads: int      # of every block


# the best of the plans timed at the distributed step's shape (PERF.md)
SCATTER_TILE_BYTES = 64 << 10      # a bin's shared tile
SCATTER_STAGE_BYTES = 64 << 10     # a partition block's staged chunk
SCATTER_THREADS = 512
SCATTER_SCRATCH_BYTES = 512 << 20  # the pairs of one group of instances
SCATTER_MAX_BINS = 8192            # bins a pass takes (shared bin arrays)
SCATTER_MAX_COLS = 32              # columns a pass stages per point
_SCATTER_SMEM = 200 << 10          # a partition block's shared memory
_SCATTER_ITEMS = 16                # points a thread holds (csrc ITEMS)


def scatter_plan(m: int, n: int, table_size: int, k: int, *,
                 tile_bytes: int = SCATTER_TILE_BYTES,
                 stage_bytes: int = SCATTER_STAGE_BYTES,
                 scratch_bytes: int = SCATTER_SCRATCH_BYTES,
                 threads: int = SCATTER_THREADS,
                 max_bins: int = SCATTER_MAX_BINS,
                 max_cols: int = SCATTER_MAX_COLS) -> ScatterPlan:
    """The k columns in the fewest even groups of at most ``max_cols``
    (cols a group), bins of W slots, the largest power of 2 whose W*cols
    floats fit tile_bytes (at most 2^16: the pairs keep a bin's slot as
    uint16; no more than table_size needs), taken ``max_bins`` a pass,
    chunks of C points whose staged (bin, slot, contrib) fit stage_bytes
    beside the pass's three bin counters and whose points the block's
    ``threads`` hold 16 a thread, and groups of instances whose pairs
    (2 + 4*cols bytes a point) fit scratch_bytes, balanced over the m
    instances.  Every (table_size, k) gets a plan."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"scatter: threads={threads} is not a multiple of "
                         f"32 in [32, 1024]")
    if not (1 <= max_bins <= SCATTER_MAX_BINS
            and 1 <= max_cols <= SCATTER_MAX_COLS):
        raise ValueError(f"scatter: max_bins={max_bins}, max_cols="
                         f"{max_cols} out of [1, {SCATTER_MAX_BINS}], "
                         f"[1, {SCATTER_MAX_COLS}]")
    k = max(1, k)
    max_cols = max(1, min(max_cols, (2 ** 31 - 1) // max(1, n)))  # n*cols: int
    cols = -(-k // -(-k // max_cols))
    w = min(1 << (max(1, tile_bytes // (4 * cols)).bit_length() - 1),
            1 << 16, 1 << (max(1, table_size) - 1).bit_length())
    bins = -(-table_size // w)
    window = max(1, min(bins, max_bins))
    stage = min(stage_bytes, _SCATTER_SMEM - 12 * window)
    chunk = max(32, min(stage // (4 * cols + 4), _SCATTER_ITEMS * threads)
                // 32 * 32)
    group = max(1, min(m, scratch_bytes // max(1, n * (2 + 4 * cols)),
                       (2 ** 31 - 1) // max(1, n)))
    group = -(-m // -(-m // group))
    return ScatterPlan(w, bins, window, cols, chunk, group, threads)


def _scatter_args(slot, contrib, table_size):
    m, n = slot.shape
    _need(slot, "slot", torch.int32, (m, n))
    _need(contrib, "contrib", torch.float32)
    if contrib.ndim not in (2, 3) or tuple(contrib.shape[:2]) != (m, n):
        raise ValueError(f"contrib must be (m={m}, n={n}[, k]), got "
                         f"{tuple(contrib.shape)}")
    if m > 65535 or not 0 <= table_size < 2 ** 31:
        raise ValueError(f"scatter: m={m}, table_size={table_size} out of "
                         f"range")
    return m, n, contrib.shape[2] if contrib.ndim == 3 else 1


def _tables(slot, contrib, table_size):
    return torch.empty((slot.shape[0], int(table_size))
                       + tuple(contrib.shape[2:]), dtype=torch.float32,
                       device=slot.device)


def bin_scatter_cuda(slot, contrib, table_size: int):
    """tables[s, b(, j)] = sum_{i: slot[s, i] = b} contrib[s, i(, j)] for
    an index without a layout; slot (m, n) int32 in [0, table_size),
    contrib (m, n) or (m, n, k) f32 -> (m, B) or (m, B, k).  Points are
    partitioned into bins of the table and each bin summed in shared
    memory, as ``scatter_plan`` cuts the work."""
    m, n, k = _scatter_args(slot, contrib, table_size)
    return _bin_scatter(slot, contrib, table_size,
                        scatter_plan(m, n, int(table_size), k))


def _bin_scatter(slot, contrib, table_size: int, plan: ScatterPlan):
    """``bin_scatter_cuda`` at a given plan (tests try others)."""
    m, n, k = _scatter_args(slot, contrib, table_size)
    tables = _tables(slot, contrib, table_size)
    if tables.numel() == 0:
        return tables
    dev = slot.device
    smem = max(plan.tile_slots * plan.cols * 4,
               12 * plan.window + plan.chunk * (4 * plan.cols + 4))
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"scatter: {plan} needs {smem} bytes of shared "
                         f"memory a block, more than the card's {limit}")
    g, p = plan.group, plan.window
    counts = torch.empty(g * p, dtype=torch.int32, device=dev)
    offsets = torch.empty(g * (p + 1), dtype=torch.int32, device=dev)
    cursor = torch.empty(g * p, dtype=torch.int32, device=dev)
    pslot = torch.empty(g * n, dtype=torch.int16, device=dev)
    pval = torch.empty(g * n * plan.cols, dtype=torch.float32, device=dev)
    lib = _lib()
    count_launch(bin_scatter_cuda, (m, n, int(table_size), k))
    rc = lib.bin_scatter_launch(
        slot.data_ptr(), contrib.data_ptr(), tables.data_ptr(), m, n,
        int(table_size), k, plan.tile_slots, plan.window, plan.cols,
        plan.chunk, g, plan.threads, counts.data_ptr(), offsets.data_ptr(),
        cursor.data_ptr(), pslot.data_ptr(), pval.data_ptr(),
        stream_ptr(dev))
    check(rc, "bin_scatter", lib.binning_error_string)
    return tables


def _route_lib():
    lib = load("route")
    if lib.route_pack_launch.argtypes is None:
        lib.route_pack_launch.argtypes = [_P] * 4 + [
            _I, _L, _L, _I, _I, _I, _P]
        lib.route_unpack_launch.argtypes = [_P] * 4 + [_I, _L, _L, _I, _P]
        for fn in (lib.route_pack_launch, lib.route_unpack_launch):
            fn.restype = _I
        lib.route_error_string.argtypes = [_I]
        lib.route_error_string.restype = ctypes.c_char_p
    return lib


def _cells(cell_lay, num_cells):
    m, L = cell_lay.shape
    _need(cell_lay, "cell_lay", torch.int32, (m, L))
    if m > 65534 or not 0 <= num_cells < 2 ** 31:
        raise ValueError(f"route: m={m}, num_cells={num_cells} out of range")
    return m, L


def _pack_args(cell_lay, contrib_lay, num_cells):
    m, L = _cells(cell_lay, num_cells)
    _need(contrib_lay, "contrib_lay", torch.float32)
    if contrib_lay.ndim not in (2, 3) or \
            tuple(contrib_lay.shape[:2]) != (m, L):
        raise ValueError(f"contrib_lay must be (m={m}, L={L}[, k]), got "
                         f"{tuple(contrib_lay.shape)}")
    return m, L, contrib_lay.shape[2] if contrib_lay.ndim == 3 else 1


def route_pack_cuda(cell_lay, contrib_lay, used, cap: int, *,
                    out_dtype=torch.float32):
    """send[c(, j)] = sum over layout positions (s, p) with cell_lay[s, p]
    = c of contrib_lay[s, p(, j)], summed in layout order in f32 and
    rounded once to ``out_dtype`` (f32 or bf16, nearest even); cell_lay
    (m, L) int32 (cells >= num_cells are sentinels, skipped), contrib_lay
    (m, L) or (m, L, k) f32 -> (num_cells,) or (num_cells, k) with
    num_cells = len(used) * cap, unreached cells 0.  Each real cell must be
    one contiguous run of one instance's layout, and the cells of owner o
    must be exactly [o*cap, o*cap + used[o]) (``used`` (n_shards,) int32 on
    the card): the hash-join routing guarantees both.  L % 4 == 0."""
    cap = int(cap)
    n_shards = used.shape[0] if used.ndim == 1 else -1
    _need(used, "used", torch.int32, (n_shards,))
    m, L, k = _pack_args(cell_lay, contrib_lay, n_shards * cap)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"route_pack: out_dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    if L % 4 or cell_lay.data_ptr() % 16 or contrib_lay.data_ptr() % 16:
        raise ValueError(f"route_pack: needs L % 4 == 0 (L={L}) and "
                         f"16-byte aligned cell and contrib rows")
    send = torch.empty((n_shards * cap,) + tuple(contrib_lay.shape[2:]),
                       dtype=out_dtype, device=cell_lay.device)
    if send.numel() == 0:
        return send
    lib = _route_lib()
    count_launch(route_pack_cuda, (m, L, k, n_shards * cap,
                                   dtype_name(out_dtype)))
    rc = lib.route_pack_launch(cell_lay.data_ptr(), contrib_lay.data_ptr(),
                               send.data_ptr(), used.data_ptr(), m, L, cap,
                               n_shards, k, int(out_dtype == torch.bfloat16),
                               stream_ptr(send.device))
    check(rc, "route_pack", lib.route_error_string)
    return send


def route_unpack_cuda(cell_lay, coeff_lay, back):
    """out_lay[s, p(, j)] = coeff_lay[s, p] * back[cell_lay[s, p](, j)],
    where a sentinel cell (>= len(back)) reads 0; cell_lay and coeff_lay
    (m, L), back (num_cells,) or (num_cells, k) f32 -> (m, L) or
    (m, L, k)."""
    num_cells = back.shape[0]
    m, L = _cells(cell_lay, num_cells)
    _need(coeff_lay, "coeff_lay", torch.float32, (m, L))
    _need(back, "back", torch.float32)
    if back.ndim not in (1, 2):
        raise ValueError(f"back must be (cells[, k]), got "
                         f"{tuple(back.shape)}")
    k = back.shape[1] if back.ndim == 2 else 1
    out = torch.empty((m, L) + tuple(back.shape[1:]), dtype=torch.float32,
                      device=cell_lay.device)
    if out.numel() == 0:
        return out
    lib = _route_lib()
    count_launch(route_unpack_cuda, (m, L, num_cells, k))
    rc = lib.route_unpack_launch(cell_lay.data_ptr(), coeff_lay.data_ptr(),
                                 back.data_ptr(), out.data_ptr(), m, L,
                                 num_cells, k, stream_ptr(out.device))
    check(rc, "route_unpack", lib.route_error_string)
    return out


for _fn in (bin_fused_matvec_cuda, bin_scatter_blocked_cuda, bin_gather_cuda,
            bin_readout_cuda, bin_gather_blocked_cuda, bin_scatter_cuda,
            route_pack_cuda, route_unpack_cuda):
    _fn.launches, _fn.launches_by_shape = 0, {}
del _fn
