"""A numpy model of the fused matvec B2 (``mv_chunk_kernel``,
``mv_walk_kernel`` and ``mv_fix_kernel`` in csrc/binning.cu): the same
chunks of 1024 layout positions (4 a thread, 256 threads), the same run
boundaries (a change of slot; a padding position, src = n, is a run of its
own), the same float32 multiplies and additions in the same order (in a
thread, across lanes by the shuffle scan, across warps in warp order,
across chunks in chunk order), so the kernel's output equals the model's
bit for bit.  Shared by the CPU tests, which hold it against the plain
versions and the JAX package's Pallas kernel, and by the card tests and
``chip_smoke.py``, which hold the kernel against it.  ``trap_layout``
builds the points whose layouts hold the run boundaries the kernel must get
right."""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
THREADS, PER, LANES = 256, 4, 32
WARPS = THREADS // LANES
CHUNK = THREADS * PER
PAD_KEY, ROW_EDGE = -1, -3


def _shift_up(a, o, fill):
    """Along the last axis, lane l gets lane l - o's value
    (``__shfl_up_sync``), lanes below o ``fill``."""
    out = np.empty_like(a)
    out[..., :o] = fill
    out[..., o:] = a[..., :-o]
    return out


def _chunk_sums(v, head):
    """In-chunk inclusive run sums of v (m, C, WARPS, LANES, PER) float32:
    in a thread left to right, the lanes' last sums by the Hillis-Steele
    shuffle scan, then the warps' carried in warp order."""
    acc = v.copy()
    for i in range(1, PER):
        acc[..., i] = np.where(head[..., i], v[..., i],
                               acc[..., i - 1] + v[..., i])
    lane = np.arange(LANES)
    x, f = acc[..., PER - 1].copy(), head.any(-1)
    for o in (1, 2, 4, 8, 16):
        y, g = _shift_up(x, o, 0), _shift_up(f, o, False)
        step = lane >= o
        x = np.where(step & ~f, y + x, x).astype(_F32)
        f = np.where(step, f | g, f)
    fx, ff = x[..., LANES - 1], f[..., LANES - 1]         # (m, C, WARPS)
    carry = np.zeros_like(fx)
    for w in range(1, WARPS):
        carry[..., w] = fx[..., 0] if w == 1 else np.where(
            ff[..., w - 1], fx[..., w - 1], carry[..., w - 1] + fx[..., w - 1])
    warp = np.arange(WARPS)[:, None]
    x = np.where((warp > 0) & ~f, carry[..., None] + x, x).astype(_F32)
    ex = _shift_up(x, 1, 0)
    ex[..., 0] = carry
    has_ex = (lane > 0) | (warp > 0)                      # (WARPS, LANES)
    open_ = np.logical_and.accumulate(~head, axis=-1)
    return np.where(open_ & has_ex[..., None], ex[..., None] + acc,
                    acc).astype(_F32)


def fused_matvec_model(slot_lay, coeff_lay, src, beta, *,
                       totals: bool = False) -> np.ndarray:
    """``bin_fused_matvec_cuda``'s output, computed as the kernel computes
    it: T (m, L) or (m, L, k) when ``totals``, else coeff_lay * T as
    (m, L) or (m, k, L); beta (n,) or (n, k) in point order, read through
    src (n at padding)."""
    slot = np.asarray(slot_lay, dtype=np.int64)
    coeff = np.asarray(coeff_lay, dtype=_F32)
    src = np.asarray(src, dtype=np.int64)
    b = np.asarray(beta, dtype=_F32)
    b2 = b if b.ndim == 2 else b[:, None]
    n, k = b2.shape
    m, L = slot.shape
    C = -(-L // CHUNK)
    full = C * CHUNK

    def padded(a, fill):
        out = np.full((m, full), fill, dtype=a.dtype)
        out[:, :L] = a
        return out

    inr = np.arange(full) < L
    key = padded(np.where(src < n, slot, PAD_KEY), PAD_KEY)
    srcp = padded(src, n)
    cf = padded(coeff, _F32(0))
    edge = np.full((m, 1), ROW_EDGE)
    prev = np.concatenate([edge, key[:, :-1]], 1)
    nxt = np.concatenate([key[:, 1:], edge], 1)
    head = inr & ((key == PAD_KEY) | (key != prev))
    end = inr & ((key == PAD_KEY) | (key != nxt))
    sh = (m, C, WARPS, LANES, PER)
    hc, ec = head.reshape(m, C, CHUNK), end.reshape(m, C, CHUNK)
    pos = np.arange(CHUNK)
    lens = np.clip(L - CHUNK * np.arange(C), 0, CHUNK)    # (C,)
    # the nearest run end at or after each position, in its chunk
    near = np.minimum.accumulate(np.where(ec, pos, CHUNK)[..., ::-1],
                                 axis=-1)[..., ::-1]
    has_end = near < CHUNK
    first_end = np.where(has_end[..., 0], near[..., 0], lens - 1)
    cross_l = ~hc[..., 0]
    cross_r = ~np.take_along_axis(ec, np.broadcast_to(
        (lens - 1)[None, :, None], (m, C, 1)), -1)[..., 0]
    any_head = hc.any(-1)
    seen = np.logical_or.accumulate(hc, axis=-1)
    first_run = cross_l[..., None] & ~seen
    last_run = cross_r[..., None] & ~has_end
    live = inr.reshape(C, CHUNK)[None]
    write = live & has_end & ~first_run
    # the walks: from each chunk whose last run starts in it and goes on,
    # over the chunks that run covers
    ws, wc = np.nonzero(cross_r & any_head)
    stop_at = wc + 1
    while True:
        go = ~(any_head[ws, stop_at] | ~cross_r[ws, stop_at])
        if not go.any():
            break
        stop_at = np.where(go, stop_at + 1, stop_at)

    T = np.zeros((m, C, CHUNK, k), dtype=_F32)
    for j in range(k):
        bj = np.where(srcp < n, b2[np.minimum(srcp, n - 1), j], _F32(0))
        v = (cf * bj.astype(_F32)).astype(_F32).reshape(sh)
        acc = _chunk_sums(v, head.reshape(sh)).reshape(m, C, CHUNK)
        val = np.take_along_axis(acc, np.minimum(near, CHUNK - 1), -1)
        pre = np.take_along_axis(acc, first_end[..., None], -1)[..., 0]
        suf = np.take_along_axis(acc, np.broadcast_to(
            (lens - 1)[None, :, None], (m, C, 1)), -1)[..., 0]
        tot = np.zeros((m, C + 1), dtype=_F32)
        for s, c, e in zip(ws, wc, stop_at):
            acc_run = suf[s, c]
            for d in range(c + 1, e + 1):
                acc_run = _F32(acc_run + pre[s, d])
            tot[s, c + 1:e + 1] = acc_run
        tj = np.where(write, val, _F32(0))
        tj = np.where(first_run, tot[:, :C, None], tj)
        tj = np.where(last_run & ~first_run, tot[:, 1:, None], tj)
        T[..., j] = tj
    T = T.reshape(m, full, k)[:, :L]
    if totals:
        return T if b.ndim == 2 else T[..., 0]
    out = (coeff[..., None] * T).astype(_F32)
    return out.transpose(0, 2, 1).copy() if b.ndim == 2 else out[..., 0]


# the instances of ``trap_layout``, in order
TRAPS = ("one_slot", "two_slots", "chunk_runs", "zero_coeff")


def trap_layout(rng, *, m: int = 5, n: int = 7000,
                table_size: int = 1 << 12, block_t: int = 512,
                device="cpu"):
    """(slot (m, n) int32, coeff (m, n) float32) whose slot-blocked layouts
    (block_n 128 or 64, ``block_t``) hold the run boundaries B2 must get
    right, one kind an instance (``TRAPS``), the rest random:

    * ``one_slot``: every point on slot 0, so tile 0's padding follows the
      one run, which covers several chunks;
    * ``two_slots``: n split between slot 1 (tile 0) and a slot of the last
      tile;
    * ``chunk_runs``: from layout position 0, runs of CHUNK (ending on the
      first chunk's last position), CHUNK - 1 (starting on a chunk's first
      position), CHUNK + 1 (crossing a boundary, ending on a chunk's last
      position) and 1, then random slots of the later tiles;
    * ``zero_coeff``: random slots, every coefficient 0.

    The other coefficients are small nonzero integers, so every sum is
    exact in any order."""
    if m < len(TRAPS) or n < 3 * CHUNK + 8 or table_size < 2 * block_t:
        raise ValueError(f"trap_layout needs m >= {len(TRAPS)}, n >= "
                         f"{3 * CHUNK + 8} and two tiles")
    rows = []
    half = n // 2
    for kind in TRAPS + ("random",) * (m - len(TRAPS)):
        if kind == "one_slot":
            row = np.zeros(n, np.int64)
        elif kind == "two_slots":
            row = np.concatenate([np.ones(half, np.int64),
                                  np.full(n - half, table_size - 3)])
        elif kind == "chunk_runs":
            runs = np.concatenate([np.full(CHUNK, 1), np.full(CHUNK - 1, 2),
                                   np.full(CHUNK + 1, 3), [4]])
            rest = rng.integers(block_t, table_size, n - runs.size)
            row = np.concatenate([runs, rest])
        else:
            row = rng.integers(0, table_size, n)
        rows.append(rng.permutation(row))
    slot = np.stack(rows).astype(np.int32)
    coeff = rng.integers(-3, 4, (m, n)).astype(np.float32)
    coeff[coeff == 0] = 1.0
    coeff[TRAPS.index("zero_coeff")] = 0.0
    return (torch.from_numpy(slot).to(device),
            torch.from_numpy(coeff).to(device))


# distinct slots an instance of ``skewed_points`` holds, in turn: those of
# the first instances of Table 2's forest layout (n 500000, B 2^21, the
# median-heuristic lengthscale), which put up to 303k of their points on
# one slot
FOREST_DISTINCT = (16, 4, 4042, 48, 492, 2)


def skewed_points(rng, *, m: int, n: int, table_size: int,
                  distinct=FOREST_DISTINCT, device="cpu"):
    """(slot (m, n) int32, coeff (m, n) float32) with the skew of coarse
    buckets on clustered data: instance s puts its n points on
    draws from ``distinct[s % len(distinct)]`` random slots, the i-th
    most popular with weight (i + 1)^-1.5, so the largest holds about 40
    to 75 % of the points.  Coefficients standard normal."""
    rows = []
    for s in range(m):
        d = min(distinct[s % len(distinct)], table_size)
        slots = rng.choice(table_size, d, replace=False)
        w = 1.0 / np.arange(1, d + 1) ** 1.5
        rows.append(slots[rng.choice(d, n, p=w / w.sum())])
    slot = np.stack(rows).astype(np.int32)
    coeff = rng.standard_normal((m, n)).astype(np.float32)
    return (torch.from_numpy(slot).to(device),
            torch.from_numpy(coeff).to(device))
