"""Wrapper of the CUDA featurize kernel (csrc/featurize.cu), which replaces
the TPU kernel ``featurize_pallas``.  Launches on the current stream; the
outputs come from ``torch.empty``; ``featurize_cuda.launches`` counts the
launches (``launches_by_shape`` by (n, d, m))."""
from __future__ import annotations

import ctypes

import torch

from ...core.bucket_fns import BucketFn
from .._build import check, count_launch, load, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("featurize")
    if lib.featurize_launch.argtypes is None:
        lib.featurize_launch.argtypes = [_P] * 11 + [_I] * 4 + [
            ctypes.c_float, ctypes.c_uint32, _P]
        lib.featurize_launch.restype = _I
        lib.featurize_error_string.argtypes = [_I]
        lib.featurize_error_string.restype = ctypes.c_char_p
        lib.featurize_plan.argtypes = [_I, ctypes.POINTER(_I)]
        lib.featurize_plan.restype = None
        lib.featurize_quotient.argtypes = [_P, _P, _P, ctypes.c_longlong,
                                           _P]
        lib.featurize_quotient.restype = _I
    return lib


def featurize_plan(d: int) -> dict:
    """The launch plan the kernel takes for ``d`` coordinates: points a
    thread holds, threads a group, groups a block, instances a group
    carries at once (builds the library)."""
    out = (ctypes.c_int * 4)()
    _lib().featurize_plan(d, out)
    return dict(zip(("points", "group_threads", "groups", "instances"),
                    out))


def _need(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} CUDA tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def featurize_cuda(x, w, z, r1, r2, *, f: BucketFn, table_size: int):
    """x (n, d) f32; w, z (m, d) f32; r1, r2 (m, d) uint32, all on the card.
    Returns (key1, key2, weight, sign, slot, coeff), each (m, n); slot is
    key1 & (table_size - 1) (zeros when table_size is 0)."""
    n, d = x.shape
    m = w.shape[0]
    _need(x, "x", torch.float32, (n, d))
    for name, t, dt in (("w", w, torch.float32), ("z", z, torch.float32),
                        ("r1", r1, torch.uint32), ("r2", r2, torch.uint32)):
        _need(t, name, dt, (m, d))
    if not 1 <= d <= 443:
        raise ValueError(f"featurize kernel takes 1 <= d <= 443, got {d}")
    if n >= 2 ** 31:
        raise ValueError(f"featurize kernel: n={n} out of range")
    if table_size < 0 or table_size & (table_size - 1) or table_size > 2**31:
        raise ValueError(f"table_size must be a power of 2, got {table_size}")
    dev = x.device
    key1 = torch.empty((m, n), dtype=torch.uint32, device=dev)
    key2 = torch.empty((m, n), dtype=torch.uint32, device=dev)
    weight = torch.empty((m, n), dtype=torch.float32, device=dev)
    sign = torch.empty((m, n), dtype=torch.float32, device=dev)
    slot = torch.empty((m, n), dtype=torch.int32, device=dev)
    coeff = torch.empty((m, n), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return key1, key2, weight, sign, slot, coeff
    lib = _lib()
    count_launch(featurize_cuda, (n, d, m))
    rc = lib.featurize_launch(
        x.data_ptr(), w.data_ptr(), z.data_ptr(), r1.data_ptr(),
        r2.data_ptr(), key1.data_ptr(), key2.data_ptr(), weight.data_ptr(),
        sign.data_ptr(), slot.data_ptr(), coeff.data_ptr(), n, d, m,
        f.kernel_id, f.kernel_const, max(table_size, 1) - 1, stream_ptr(dev))
    check(rc, "featurize", lib.featurize_error_string)
    return key1, key2, weight, sign, slot, coeff


featurize_cuda.launches, featurize_cuda.launches_by_shape = 0, {}


def fast_quotient_cuda(a, w):
    """a / w, elementwise (a, w f32 of one shape, on the card), as the
    kernel's fast path divides: the guarded reciprocal and Markstein's
    correction (NaN where |w| is outside [2^-60, 2^60]).  For checking that
    arithmetic against IEEE division; no path runs it."""
    _need(a, "a", torch.float32, a.shape)
    _need(w, "w", torch.float32, a.shape)
    t = torch.empty_like(a)
    if a.numel() == 0:
        return t
    lib = _lib()
    count_launch(fast_quotient_cuda, (a.numel(),))
    rc = lib.featurize_quotient(a.data_ptr(), w.data_ptr(), t.data_ptr(),
                                a.numel(), stream_ptr(a.device))
    check(rc, "featurize quotient", lib.featurize_error_string)
    return t


fast_quotient_cuda.launches, fast_quotient_cuda.launches_by_shape = 0, {}
