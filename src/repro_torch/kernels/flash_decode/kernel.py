"""Wrapper of the CUDA flash-decode kernel (csrc/flash_decode.cu), which
replaces the TPU kernel ``flash_decode_pallas``.  One launch a call on the
current stream.  The output comes from ``torch.empty``; so does the split
scratch where the splits of a cache are more than a cluster holds, and
then the arrival counters come from ``_counters`` (zeros, kept per device
and stream: the kernel's last block of each (batch, kv head) sets its
counter back to 0, so the next launch on that stream finds them zeroed,
and a launch on another stream, which may overlap it, uses its own).
``flash_decode_cuda.launches`` counts the launches (``launches_by_shape`` by
(B, T, KV, G, D, cache dtype))."""
from __future__ import annotations

import ctypes

import torch

from .._build import check, count_launch, dtype_name, load, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_G = 16           # query heads per kv head the kernel holds (csrc MAXG)
MAX_D = 256          # head_dim (csrc MAXD)
MAX_SPLIT = 1024     # ranges per (batch, kv head) (csrc MAX_SPLIT)
MAX_CLUSTER = 8      # splits combined within a cluster (csrc MAX_CLUSTER)
MIN_TILES = 2        # tiles a split takes at least, where the cache has them

_geometry: dict[tuple, tuple[int, int]] = {}
_counters: dict[tuple, torch.Tensor] = {}


def _lib():
    lib = load("flash_decode")
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = [_P] * 9 + [_I] * 8 + [
            ctypes.c_float, _P]
        lib.flash_decode_launch.restype = _I
        lib.flash_decode_geometry.argtypes = [_I, _I, _I,
                                              ctypes.POINTER(_I)]
        lib.flash_decode_geometry.restype = _I
        lib.flash_decode_error_string.argtypes = [_I]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def kernel_geometry(dev, g: int, d: int, bf16: bool) -> tuple[int, int]:
    """(tile rows, blocks the card holds at once) of the kernel that takes
    (G, D, cache dtype) on ``dev``."""
    key = (dev.index, g, d, bf16)
    if key not in _geometry:
        lib = _lib()
        out = (_I * 4)()
        with torch.cuda.device(dev):
            check(lib.flash_decode_geometry(g, d, int(bf16), out),
                  "flash_decode geometry", lib.flash_decode_error_string)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _geometry[key] = (out[0], max(1, out[2]) * sms)
    return _geometry[key]


def _counter_buffer(dev, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for the arrival counters of launches on
    the current stream of ``dev``."""
    key = (dev.index, stream_ptr(dev))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def split_plan(b: int, kv: int, t: int, slots: int,
               tile_rows: int) -> tuple[int, int]:
    """(n_split, split_rows): cut each (batch, kv head) cache of ``t`` rows
    into splits of whole tiles of ``tile_rows``, at least MIN_TILES tiles a
    split where the cache has them, and none empty.  The grid stays one
    wave of the ``slots`` blocks the card holds at once.  Up to 2
    MAX_CLUSTER splits a cache fit that wave, the splits are capped at
    MAX_CLUSTER, whose blocks the kernel launches as one cluster and
    combines in shared memory; with fewer caches still (a long cache at a
    batch of a few) the splits fill the wave, up to MAX_SPLIT, and the last
    block to finish combines them through device memory."""
    n_tiles = -(-t // tile_rows)
    per_cache = max(1, slots // (b * kv))
    if per_cache <= 2 * MAX_CLUSTER:
        per_cache = min(per_cache, MAX_CLUSTER)
    per = max(min(MIN_TILES, n_tiles), -(-n_tiles // per_cache),
              -(-n_tiles // MAX_SPLIT))
    split_rows = per * tile_rows
    return -(-t // split_rows), split_rows


def _need(t: torch.Tensor, name: str, dtypes, shape):
    if t.device.type != "cuda" or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtypes} CUDA tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def flash_decode_cuda(q, k, v, valid, softcap: float = 0.0):
    """q (B, KV, G, D) f32; k, v (B, T, KV, D) f32 or bf16 (both the same);
    valid (B, T) int32, all on the card.  Returns out (B, KV, G, D) f32:
    softmax(q k^T / sqrt(D), masked by valid) v per (batch, kv head), any
    T >= 1, G <= 16, D <= 256 with D % 8 == 0 (a cache row is whole 16-byte
    chunks, which the kernel copies asynchronously), k and v 16-byte
    aligned."""
    b, kv, g, d = q.shape
    t = k.shape[1]
    _need(q, "q", (torch.float32,), (b, kv, g, d))
    _need(k, "k", (torch.float32, torch.bfloat16), (b, t, kv, d))
    _need(v, "v", (k.dtype,), (b, t, kv, d))
    _need(valid, "valid", (torch.int32,), (b, t))
    if not (1 <= g <= MAX_G and 8 <= d <= MAX_D and d % 8 == 0 and t >= 1):
        raise ValueError(f"flash decode kernel takes 1 <= G <= {MAX_G}, "
                         f"8 <= D <= {MAX_D} with D % 8 == 0, T >= 1; got "
                         f"G={g}, D={d}, T={t}")
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash decode kernel: k and v must be 16-byte "
                         "aligned")
    if b * kv > 65535 or b * t >= 2 ** 31:
        raise ValueError(f"flash decode kernel: B={b}, KV={kv}, T={t} out "
                         f"of range")
    dev = q.device
    if b == 0:
        return torch.empty((b, kv, g, d), dtype=torch.float32, device=dev)
    tile_rows, slots = kernel_geometry(dev, g, d, k.dtype == torch.bfloat16)
    return _launch(q, k, v, valid, softcap,
                   *split_plan(b, kv, t, slots, tile_rows))


def _launch(q, k, v, valid, softcap, n_split, split_rows):
    """One launch of the kernel on checked inputs, at the plan (n_split,
    split_rows)."""
    b, kv, g, d = q.shape
    t = k.shape[1]
    dev = q.device
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=dev)
    scratch = []        # held until the launch is queued
    if n_split > MAX_CLUSTER:
        m_part = torch.empty((b * kv, n_split, g), dtype=torch.float32,
                             device=dev)
        scratch = [m_part, torch.empty_like(m_part),
                   torch.empty((b * kv, n_split, g, d), dtype=torch.float32,
                               device=dev), _counter_buffer(dev, b * kv)]
    parts = [x.data_ptr() for x in scratch] or [None] * 4
    lib = _lib()
    count_launch(flash_decode_cuda, (b, t, kv, g, d, dtype_name(k.dtype)))
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), *parts,
        out.data_ptr(), b, t, kv, g, d, n_split, split_rows,
        int(k.dtype == torch.bfloat16), float(softcap), stream_ptr(dev))
    check(rc, "flash_decode", lib.flash_decode_error_string)
    return out


flash_decode_cuda.launches = 0
flash_decode_cuda.launches_by_shape = {}
