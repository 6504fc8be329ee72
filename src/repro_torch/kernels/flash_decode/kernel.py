"""Wrapper of the CUDA flash-decode kernel (csrc/flash_decode.cu), which
replaces the TPU kernel ``flash_decode_pallas``.  Launches on the current
stream; outputs and the split scratch come from ``torch.empty``;
``flash_decode_cuda.launches`` counts the launches (``launches_by_shape``
by (B, T, KV, G, D, cache dtype))."""
from __future__ import annotations

import ctypes

import torch

from .._build import check, count_launch, dtype_name, load, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int

TILE_T = 32          # cache rows a block scores at a time (csrc BT)
MAX_G = 16           # query heads per kv head the kernel holds (csrc MAXG)
MAX_D = 256          # head_dim (csrc MAXD)
BLOCKS_PER_SM = 8    # split the cache until about this many blocks per SM


def _lib():
    lib = load("flash_decode")
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = [_P] * 8 + [_I] * 8 + [
            ctypes.c_float, _P]
        lib.flash_decode_launch.restype = _I
        lib.flash_decode_error_string.argtypes = [_I]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _need(t: torch.Tensor, name: str, dtypes, shape):
    if t.device.type != "cuda" or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtypes} CUDA tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def split_plan(b: int, kv: int, t: int, num_sms: int) -> tuple[int, int]:
    """(n_split, split_rows): cut each (batch, kv head) cache of ``t`` rows
    into splits of whole tiles, enough of them that the grid has about
    BLOCKS_PER_SM blocks per SM, and no split empty."""
    n_tiles = -(-t // TILE_T)
    want = max(1, -(-BLOCKS_PER_SM * num_sms // (b * kv)))
    per = -(-n_tiles // min(want, n_tiles))
    split_rows = per * TILE_T
    return -(-t // split_rows), split_rows


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
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, split_rows = split_plan(b, kv, t, sms)
    m_part = torch.empty((b * kv, n_split, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * kv, n_split, g, d), dtype=torch.float32,
                           device=dev)
    lib = _lib()
    count_launch(flash_decode_cuda,
                 (b, t, kv, g, d, dtype_name(k.dtype)))
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), b, t, kv, g, d, n_split, split_rows,
        int(k.dtype == torch.bfloat16), float(softcap), stream_ptr(dev))
    check(rc, "flash_decode", lib.flash_decode_error_string)
    return out


flash_decode_cuda.launches = 0
flash_decode_cuda.launches_by_shape = {}
