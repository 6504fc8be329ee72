"""A numpy model of the blocked scatter B3 (``scatter_blocked_kernel`` in
csrc/binning.cu): the same chunks of 128 layout positions, 4 a lane, the
same run boundaries (the padding cut at a tile's first descent, the run
carried across chunks) and the same float32 additions in the same order,
so the kernel's tables equal the model's bit for bit.  Shared by the CPU
tests, which hold it against ``scatter_blocked_ref``, and the card tests,
which hold the kernel against it.  The layouts built for both are here
too: ``trap_layout_case`` makes the tiles whose run boundaries the kernel
must get right."""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
LANES, PER_LANE = 32, 4
CHUNK = LANES * PER_LANE


def scatter_blocked_model(blk_start, slot_lay, contrib_lay, *, block_n: int,
                          block_t: int) -> np.ndarray:
    """tables (m, T*bt) or (m, k, T*bt) float32 for contrib_lay (m, L) or
    (m, k, L), summed as the kernel sums them."""
    blk_start = np.asarray(blk_start, dtype=np.int64)
    slot_lay = np.asarray(slot_lay, dtype=np.int64)
    contrib = np.asarray(contrib_lay, dtype=_F32)
    multi = contrib.ndim == 3
    c = contrib if multi else contrib[:, None]
    m, k, _ = c.shape
    num_tiles = blk_start.shape[1] - 1
    out = np.zeros((m, k, num_tiles * block_t), dtype=_F32)
    for s in range(m):
        for t in range(num_tiles):
            p0 = blk_start[s, t] * block_n
            p1 = blk_start[s, t + 1] * block_n
            for j in range(k):
                tab = out[s, j, t * block_t:(t + 1) * block_t]
                if p0 < p1:
                    _runs(slot_lay[s], c[s, j], tab, p0, p1, t * block_t,
                          block_t)
    return out if multi else out[:, 0]


def _shift_up(a, o, fill):
    """Lane l gets lane l - o's value (``__shfl_up_sync``), lanes below o
    ``fill``."""
    out = np.empty_like(a)
    out[:o] = fill
    out[o:] = a[:-o]
    return out


def _runs(srow, crow, tab, p0, p1, lo, bt):
    """One tile's run sums of one column into ``tab``: the warp's loop of
    ``scatter_runs``, lanes as the rows of (32, 4) arrays."""
    lane = np.arange(LANES)
    idx = PER_LANE * lane[:, None] + np.arange(PER_LANE)   # chunk offsets
    carry_key, carry, last, ended = -1, _F32(0), -1, False
    for c in range(p0, p1, CHUNK):
        q = c + idx
        inr = q < p1
        qc = np.minimum(q, p1 - 1)
        sl = np.where(inr, srow[qc], 0)
        v = np.where(inr, crow[qc], _F32(0)).astype(_F32)
        # the first descent of the chunk: from it on, padding
        up = _shift_up(sl[:, 3], 1, 0)
        up[0] = last
        prev = np.concatenate([up[:, None], sl[:, :3]], 1)
        desc = inr & (sl < prev)
        if ended:
            cut = 0
        elif desc.any():
            cut, ended = int(idx[desc].min()), True
        else:
            cut = CHUNK
        last = int(sl[31, 3])
        live = (idx < cut) & inr & (sl - lo >= 0) & (sl - lo < bt)
        key = np.where(live, sl, -1)
        kup = _shift_up(key[:, 3], 1, 0)
        kup[0] = carry_key
        if carry_key >= 0 and key[0, 0] != carry_key:
            tab[carry_key - lo] = carry         # the carried run ended
        head = key != np.concatenate([kup[:, None], key[:, :3]], 1)
        if not head[0, 0]:
            v[0, 0] = _F32(carry + v[0, 0])     # the run goes on
        a = v.copy()
        for i in range(1, PER_LANE):
            a[:, i] = np.where(head[:, i], v[:, i], a[:, i - 1] + v[:, i])
        # segmented inclusive scan of the lanes' last partial sums
        x, f = a[:, 3].copy(), head.any(1)
        for o in (1, 2, 4, 8, 16):
            y, g = _shift_up(x, o, 0), _shift_up(f, o, False)
            step = lane >= o
            x = np.where(step & ~f, y + x, x).astype(_F32)
            f = np.where(step, f | g, f)
        ex = _shift_up(x, 1, 0)
        open_ = np.logical_and.accumulate(~head, axis=1)
        a = np.where(open_, ex[:, None] + a, a).astype(_F32)
        kdown = np.concatenate([key[1:, 0], key[31:, 3]])
        nxt = np.concatenate([key[:, 1:], kdown[:, None]], 1)
        end = (key >= 0) & (key != nxt)
        tab[key[end] - lo] = a[end]
        carry_key, carry = int(key[31, 3]), a[31, 3]
    if carry_key >= 0:
        tab[carry_key - lo] = carry


def trap_layout_case(rng, *, m: int = 3, n: int = 1500,
                     table_size: int = 1 << 12, block_n: int = 128,
                     block_t: int = 512, device="cpu"):
    """(slot (m, n) int32, coeff (m, n) float32) whose slot-blocked layout
    holds the run boundaries B3 must get right, on every instance:

    * tile 0: slot 0 with points, higher slots after it, then padding
      positions of slot 0 (the tile's count is not a multiple of block_n);
    * tile 1 empty;
    * tile 2: one slot holding the whole tile, longer than a chunk of 128;
    * tile 3: runs of 4 ending at each lane's last position, then a run
      from position 120 to 140 of its range (across the first chunk's
      end);
    * the other slots random.

    Coefficients are small nonzero integers (positive on slot 0), so every
    sum is exact in any order and slot 0's is not 0."""
    bt = block_t
    if table_size < 5 * bt:
        raise ValueError("trap_layout_case needs at least 5 tiles")
    rows = []
    for _ in range(m):
        t0 = np.concatenate([np.zeros(5, np.int64),
                             rng.integers(1, bt, 60)])   # 65 points: padded
        t2 = np.full(300, 2 * bt + 7)
        t3 = np.concatenate([3 * bt + np.arange(120) // 4,
                             np.full(21, 3 * bt + 200),
                             3 * bt + 201 + np.arange(107)])
        rest = n - len(t0) - len(t2) - len(t3)
        if rest < 0:
            raise ValueError("trap_layout_case needs n >= 613")
        other = rng.integers(4 * bt, table_size, rest)
        rows.append(rng.permutation(np.concatenate([t0, t2, t3, other])))
    slot = np.stack(rows).astype(np.int32)
    coeff = rng.integers(-3, 4, (m, n)).astype(np.float32)
    coeff[coeff == 0] = 1.0
    coeff[slot == 0] = np.abs(coeff[slot == 0])   # slot 0's sum is not 0
    return (torch.from_numpy(slot).to(device),
            torch.from_numpy(coeff).to(device))
