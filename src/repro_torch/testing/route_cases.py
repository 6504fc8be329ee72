"""Inputs of the hash join's route unpack (B8) that break every order the
routing gives its cells, and a numpy oracle of the unpack.  Shared by the
CPU tests, the card tests and ``chip_smoke.py``.

The routing's cells ascend along an instance's layout, each real cell is
one run, and padding carries one sentinel (``core/distributed.py``
``_make_route_plan``).  The unpack may only be fast on that order, never
right because of it: these cells are random over [-num_cells,
2 num_cells), with planted sentinels at num_cells and at 2^31 - 1, the
most negative int32 and descending runs; coefficients and values hold
signed zeros; ``offset`` moves every array one or two elements into a
larger buffer, so no row is 16-byte aligned."""
from __future__ import annotations

import numpy as np
import torch

# the shapes of the adversarial cases: L (none a multiple of 4; at m = 65,
# 4097 fills whole tiles of the kernel and leaves a tail), k (0: back is
# (num_cells,)), m
UNPACK_LS = (1, 3, 5, 4097)
UNPACK_KS = (0, 1, 3, 4)
UNPACK_MS = (1, 65)
INT32_MAX = 2 ** 31 - 1


def unpack_case(seed: int, m: int, L: int, k: int, *, coeff: bool = True,
                offset: bool = False, device="cpu"):
    """(cell_lay (m, L) int32, coeff_lay (m, L) f32 or None, back
    (num_cells,) for k = 0, else (num_cells, k), f32), all contiguous.
    With ``offset`` cell_lay starts one element into its buffer, coeff_lay
    two and back one."""
    rng = np.random.default_rng(seed)
    num_cells = int(rng.integers(500, 1500))
    cell = rng.integers(-num_cells, 2 * num_cells, (m, L)).astype(np.int64)
    flat = cell.reshape(-1)
    pos = np.arange(flat.size)
    flat[pos % 7 == 0] = num_cells
    flat[pos % 11 == 3] = INT32_MAX
    flat[pos % 13 == 5] = -2 ** 31
    # descending runs of real cells, each cell repeated
    run = pos % 17 == 9
    flat[run] = (num_cells - 1 - pos[run] // 17) % num_cells
    flat[pos % 19 == 10] = flat[np.maximum(pos[pos % 19 == 10] - 1, 0)]
    cell = flat.reshape(m, L).astype(np.int32)
    tail = () if k == 0 else (k,)
    back = rng.standard_normal((num_cells,) + tail).astype(np.float32)
    back.reshape(-1)[::23] = -0.0
    back.reshape(-1)[5::29] = 0.0
    cf = None
    if coeff:
        cf = rng.standard_normal((m, L)).astype(np.float32)
        cf.reshape(-1)[::31] = -0.0
        cf.reshape(-1)[2::37] = 0.0

    def place(a, shift):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not offset:
            return t.to(device)
        buf = torch.zeros(t.numel() + shift, dtype=t.dtype, device=device)
        view = buf[shift:].view(t.shape)
        view.copy_(t)
        return view

    return (place(cell, 1), None if cf is None else place(cf, 2),
            place(back, 1))


def unpack_oracle(cell_lay: np.ndarray, coeff_lay, back: np.ndarray):
    """The unpack in numpy: coeff * back[cell](, j) with cells outside
    [0, len(back)) reading 0; coeff None reads the values unscaled."""
    num_cells = back.shape[0]
    c = cell_lay.astype(np.int64)
    ok = (c >= 0) & (c < num_cells)
    vals = back[np.where(ok, c, 0)]
    okb = ok if back.ndim == 1 else ok[..., None]
    vals = np.where(okb, vals, np.float32(0.0)).astype(np.float32)
    if coeff_lay is None:
        return vals
    cf = coeff_lay if back.ndim == 1 else coeff_lay[..., None]
    return (cf * vals).astype(np.float32)


def unpack_bits(t: torch.Tensor) -> np.ndarray:
    """A float32 tensor's bits, as a numpy uint32 array (signed zeros
    differ)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
