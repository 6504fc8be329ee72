"""The port's flash-decode op (B9) against the JAX package's: the plain
version the CPU runs against ``flash_decode_ref`` and the Pallas kernel in
interpret mode, and the split-KV scheme of the CUDA kernel, emulated here in
PyTorch, against the plain version.  Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import decode_attend_op as jax_decode_op
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.flash_decode import flash_decode_ref as jax_ref
from repro.models.attention import _expand_kv, _sdpa
from repro_torch.kernels.flash_decode import decode_attend_op, flash_decode_ref
from repro_torch.kernels.flash_decode.kernel import (MAX_CLUSTER, MAX_SPLIT,
                                                     MIN_TILES, split_plan)


def _inputs(b, kv, g, d, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, (b, 1))
    valid = (np.arange(t)[None, :] < lens).astype(np.int32)
    return q, k, v, valid


def _both(q, k, v, valid, bf16):
    """The same inputs for JAX and for the port; bf16 caches are rounded
    from the same f32 values on both sides."""
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if bf16:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.bfloat16(), tv.bfloat16()
    return ((jnp.asarray(q), jk, jv, jnp.asarray(valid)),
            (torch.from_numpy(q), tk, tv, torch.from_numpy(valid)))


@pytest.mark.parametrize("b,kv,g,d,t", [(1, 1, 1, 64, 256), (2, 2, 3, 64, 512),
                                        (2, 4, 1, 128, 256), (2, 1, 4, 128, 512)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_matches_reference_and_pallas(b, kv, g, d, t, bf16):
    j, p = _both(*_inputs(b, kv, g, d, t, seed=b * t + d), bf16)
    got = flash_decode_ref(*p).numpy()
    tol = 3e-3 if bf16 else 3e-6
    np.testing.assert_allclose(got, np.asarray(jax_ref(*j)), atol=tol)
    np.testing.assert_allclose(
        got, np.asarray(flash_decode_pallas(*j, interpret=True, block_t=256)),
        atol=tol)


def test_single_valid_row_returns_that_value_row():
    q, k, v, _ = _inputs(2, 1, 2, 32, 128, seed=9)
    valid = np.zeros((2, 128), np.int32)
    valid[:, 0] = 1
    out = flash_decode_ref(*_both(q, k, v, valid, False)[1]).numpy()
    np.testing.assert_allclose(out, np.broadcast_to(v[:, 0][:, :, None, :],
                                                    out.shape), atol=1e-5)


@pytest.mark.parametrize("pattern", ["leading", "trailing", "both", "none"])
def test_masked_stretches_match_reference(pattern):
    """Fully masked stretches at the start and end of the cache (the early
    decode steps of a global layer) and a cache with no valid row at all
    (the reference then averages v: every score is the finite -1e30)."""
    b, kv, g, d, t = 2, 2, 3, 32, 300
    q, k, v, _ = _inputs(b, kv, g, d, t, seed=11)
    valid = np.zeros((b, t), np.int32)
    if pattern == "leading":
        valid[:, 200:] = 1
    elif pattern == "trailing":
        valid[:, :40] = 1
    elif pattern == "both":
        valid[0, 130:131] = 1
        valid[1, 64:190] = 1
    j, p = _both(q, k, v, valid, False)
    want = np.asarray(jax_ref(*j))
    np.testing.assert_allclose(flash_decode_ref(*p).numpy(), want, atol=3e-6)
    for tiles in KERNEL_TILES:
        np.testing.assert_allclose(_split_kv(*p, slots=4, **tiles).numpy(),
                                   want, atol=3e-6)
    if pattern == "none":
        np.testing.assert_allclose(want, np.broadcast_to(
            v.mean(1)[:, :, None, :], want.shape), atol=1e-5)


@pytest.mark.parametrize("softcap", [0.0, 2.0])
def test_op_matches_decode_sdpa_with_softcap(softcap):
    """decode_attend_op (B, H, D) against the JAX decode softmax itself
    (``_sdpa`` on head-expanded caches with the validity mask), where the
    logit softcap lives."""
    b, h, kv, d, t = 3, 6, 2, 16, 70
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, d)).astype(np.float32) * 3
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    valid = (rng.random((b, t)) < 0.7).astype(np.int32)
    want = _sdpa(jnp.asarray(q)[:, None], _expand_kv(jnp.asarray(k), h),
                 _expand_kv(jnp.asarray(v), h),
                 q_pos=jnp.zeros((b, 1), jnp.int32),
                 k_pos=jnp.zeros((t,), jnp.int32), causal=False, window=0,
                 softcap=softcap, k_valid=jnp.asarray(valid) > 0)[:, 0]
    got = decode_attend_op(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(valid),
                           softcap=softcap)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)


def test_op_reshape_matches_reference_op():
    b, h, kv, d, t = 2, 8, 2, 32, 256
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    valid = (np.arange(t)[None] < np.array([[100], [256]])).astype(np.int32)
    got = decode_attend_op(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    for use_kernel in (False, True):
        want = jax_decode_op(*(jnp.asarray(a) for a in (q, k, v, valid)),
                             use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)
    with pytest.raises(ValueError, match="group"):
        decode_attend_op(torch.zeros(1, 3, 4), torch.zeros(1, 5, 2, 4),
                         torch.zeros(1, 5, 2, 4),
                         torch.ones(1, 5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the CUDA kernel's split-KV scheme, emulated in PyTorch
# ---------------------------------------------------------------------------

# the tiles of the kernel's two code paths: fma_kernel (32-row tiles, one
# state a block) and mma_kernel (64-row tiles, a state per 16-row warp share)
KERNEL_TILES = (dict(tile_rows=32), dict(tile_rows=64, warp_rows=16))


def _online(q, k, v, valid, rows, softcap, state):
    """One online-softmax step over cache rows ``rows`` (a slice), float64."""
    m, l, acc = state
    d = q.shape[-1]
    sc = torch.einsum("bkgd,btkd->bkgt", q, k[:, rows]) / d ** 0.5
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(valid[:, None, None, rows] > 0, sc, -1e30)
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p,
                                                  v[:, rows]))


def _merge(states):
    """Partials (m, l, acc) weighed by exp(m_s - M), as the kernel's merge
    of its warps and its last block's combine of the splits."""
    mx = torch.stack([st[0] for st in states]).amax(0)
    w = [torch.exp(st[0] - mx) for st in states]
    return (mx, sum(wi * st[1] for wi, st in zip(w, states)),
            sum(wi[..., None] * st[2] for wi, st in zip(w, states)))


def _split_kv(q, k, v, valid, softcap=0.0, slots=132, tile_rows=32,
              warp_rows=None):
    """What csrc/flash_decode.cu computes, in its order: per (batch, kv
    head), splits of ``split_rows`` rows from ``split_plan``; a split walks
    its tiles of ``tile_rows`` with the online softmax from m = -1e30 (with
    ``warp_rows``, each warp its own rows of every tile and its own state,
    the warps merged at the end of the split); the last block to finish
    merges the splits and divides by the weighed sum."""
    b, kv, g, d = q.shape
    t = k.shape[1]
    n_split, rows = split_plan(b, kv, t, slots, tile_rows)
    qf, kf, vf = q.double(), k.double(), v.double()
    per = warp_rows or tile_rows
    init = (torch.full((b, kv, g), -1e30, dtype=torch.float64),
            torch.zeros((b, kv, g), dtype=torch.float64),
            torch.zeros((b, kv, g, d), dtype=torch.float64))
    parts = []
    for s in range(n_split):
        end = min(t, (s + 1) * rows)
        states = [init] * (tile_rows // per)
        for t0 in range(s * rows, end, tile_rows):
            for w in range(tile_rows // per):
                lo = t0 + w * per
                if lo < end:
                    states[w] = _online(qf, kf, vf, valid,
                                        slice(lo, min(lo + per, end)),
                                        softcap, states[w])
        parts.append(_merge(states))
    _, lsum, osum = _merge(parts)
    return (osum / lsum.clamp_min(1e-30)[..., None]).float()


@pytest.mark.parametrize("b,kv,t,sms", [(1, 1, 1, 132), (8, 1, 2112, 132),
                                        (8, 1, 512, 132), (128, 1, 32768, 132),
                                        (3, 8, 517, 132), (2, 2, 1000, 1)])
def test_split_plan_covers_the_cache(b, kv, t, sms):
    """No empty split; MIN_TILES tiles a split where the cache has them;
    one wave of blocks (1 and 2 blocks an SM)."""
    for tile_rows in (32, 64):
        for slots in (sms, 2 * sms):
            n_split, rows = split_plan(b, kv, t, slots, tile_rows)
            n_tiles = -(-t // tile_rows)
            assert rows % tile_rows == 0 and 1 <= n_split <= MAX_SPLIT
            assert (n_split - 1) * rows < t <= n_split * rows
            assert rows // tile_rows >= min(MIN_TILES, n_tiles)
            assert n_split <= max(1, slots // (b * kv))


@pytest.mark.parametrize("t,n_split,tiles", [(512, 8, 2), (2112, 8, 9)])
def test_split_plan_at_the_serve_shapes(t, n_split, tiles):
    """gemma3-1b's decode (B 8, KV 1, f32: 32-row tiles, one block an SM):
    the local rings (T 512) in 8 splits of 2 tiles, the global caches
    (T 2112) in 8 splits of 9 tiles (the last 3): one cluster a cache."""
    assert split_plan(8, 1, t, 132, 32) == (n_split, tiles * 32)


@pytest.mark.parametrize("b,kv,t,n_split", [(1, 1, 32768, 128),
                                            (4, 1, 8192, 32),
                                            (8, 1, 8192, 8),
                                            (128, 1, 32768, 1)])
def test_split_plan_clusters_unless_few_caches(b, kv, t, n_split):
    """At most MAX_CLUSTER splits (one cluster a cache) while a wave holds
    no more than 2 MAX_CLUSTER a cache; beyond, the splits fill the wave."""
    got = split_plan(b, kv, t, 132, 32)[0]
    assert got == n_split
    assert got <= MAX_CLUSTER or 132 // (b * kv) > 2 * MAX_CLUSTER


@pytest.mark.parametrize("t,lens", [(2112, "random"), (517, "wrapped"),
                                    (300, "one")])
def test_split_scheme_matches_plain(t, lens):
    """The split-KV combine with the finite -1e30 mask agrees with the
    plain softmax, also where whole splits hold no valid row."""
    b, kv, g, d = 3, 1, 4, 32
    q, k, v, valid = _inputs(b, kv, g, d, t, seed=t)
    if lens == "wrapped":
        valid[:] = 1
    elif lens == "one":
        valid[:] = 0
        valid[:, t // 2] = 1
    p = _both(q, k, v, valid, False)[1]
    for softcap in (0.0, 1.5):
        for tiles in KERNEL_TILES:
            np.testing.assert_allclose(
                _split_kv(*p, softcap=softcap, slots=16, **tiles).numpy(),
                flash_decode_ref(*p, softcap=softcap).numpy(), atol=3e-6)
