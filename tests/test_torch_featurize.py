"""Port featurization (repro_torch) against the JAX package: keys, slot and
sign bitwise, weights to atol 2e-6, on the CPU's plain path.  The inputs
are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket_fns as jbf
from repro.core import lsh as jlsh
from repro.kernels.featurize import featurize_op as jax_featurize_op
from repro_torch.core import bucket_fns as tbf
from repro_torch.core import lsh as tlsh
from repro_torch.kernels.featurize import featurize_cuda, featurize_op


def _inputs(seed, n, d, m):
    """Points and instances with large |h| (rows 0-7, and w = 1e-4 on the
    last instance, past the int32 range), half-integer t (w = 1, z = 0 on
    instance 0) and multipliers near 2^32."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d), dtype=np.float32) * 4.0 - 2.0)
    x[:8] *= np.float32(1e6)
    x[8:16] = (np.arange(8, dtype=np.float32) - 3.5)[:, None]
    w = rng.gamma(2.0, 1.0, (m, d)).astype(np.float32)
    z = (rng.random((m, d)) * w).astype(np.float32)
    w[0, :2], z[0, :2] = 1.0, 0.0
    w[-1, -1] = 1e-4
    r1 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r2 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r1[:, 0] = r2[:, 0] = np.uint32(2 ** 32 - 1)
    return x, w, z, r1, r2


def _both(x, w, z, r1, r2, fname, table_size):
    jp = jlsh.LSHParams(w=jnp.asarray(w), z=jnp.asarray(z),
                        r1=jnp.asarray(r1), r2=jnp.asarray(r2))
    want = jlsh.featurize(jp, jbf.get_bucket_fn(fname), jnp.asarray(x))
    want_slot = jlsh.slots_from_features(want, table_size)
    tp = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    got = featurize_op(tp, tbf.get_bucket_fn(fname), x,
                       table_size=table_size)
    return got, want, want_slot


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
@pytest.mark.parametrize("n,d,m", [(64, 3, 2), (200, 11, 3), (40, 64, 2)])
def test_featurize_matches_jax(fname, n, d, m):
    x, w, z, r1, r2 = _inputs(n + d + m, n, d, m)
    got, want, want_slot = _both(x, w, z, r1, r2, fname, 1 << 12)
    assert got.key1.dtype == torch.uint32 and got.slot.dtype == torch.int32
    np.testing.assert_array_equal(got.key1.numpy(), np.asarray(want.key1))
    np.testing.assert_array_equal(got.key2.numpy(), np.asarray(want.key2))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want_slot))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.coeff.numpy(),
                               np.asarray(want.weight * want.sign),
                               atol=2e-6, rtol=0)


def test_featurize_matches_pallas_kernel_interpret():
    """The same inputs through the TPU kernel in interpret mode."""
    x, w, z, r1, r2 = _inputs(7, 130, 5, 2)
    jp = jlsh.LSHParams(w=jnp.asarray(w), z=jnp.asarray(z),
                        r1=jnp.asarray(r1), r2=jnp.asarray(r2))
    want = jax_featurize_op(jp, jbf.get_bucket_fn("tent"), jnp.asarray(x),
                            interpret=True)
    got = featurize_op(tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu"),
                       tbf.get_bucket_fn("tent"), x)
    assert got.slot is None and got.coeff is None
    np.testing.assert_array_equal(got.key1.numpy(), np.asarray(want.key1))
    np.testing.assert_array_equal(got.key2.numpy(), np.asarray(want.key2))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
def test_bucket_fns_match_jax(fname):
    u = np.linspace(-0.8, 0.8, 1601).astype(np.float32)
    want = np.asarray(jbf.get_bucket_fn(fname)(jnp.asarray(u)))
    got = tbf.get_bucket_fn(fname)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tbf.get_bucket_fn(fname).acorr_y,
                                  jbf.get_bucket_fn(fname).acorr_y)


def test_sample_lsh_params_contract():
    p = tlsh.sample_lsh_params(np.random.default_rng(0), 16, 5,
                               tlsh.GammaPDF(2.0, 1.0), lengthscale=3.0,
                               device="cpu")
    assert p.w.dtype == torch.float32 and p.r1.dtype == torch.uint32
    assert bool((p.w > 0).all()) and bool((p.z >= 0).all())
    assert bool((p.z <= p.w).all())
    assert bool(((p.r1.to(torch.int64) & 1) == 1).all())
    assert bool(((p.r2.to(torch.int64) & 1) == 1).all())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never takes the plain path: a CPU tensor raises."""
    x, w, z, r1, r2 = _inputs(1, 16, 3, 1)
    p = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        featurize_cuda(torch.from_numpy(x), *p,
                       f=tbf.get_bucket_fn("rect"), table_size=64)


def test_table_size_must_be_power_of_two():
    x, w, z, r1, r2 = _inputs(2, 16, 3, 1)
    p = tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu")
    with pytest.raises(ValueError, match="power of 2"):
        featurize_op(p, tbf.get_bucket_fn("rect"), x, table_size=100)


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic (csrc/featurize.cu), modelled exactly in numpy
# ---------------------------------------------------------------------------

F32, F64 = np.float32, np.float64
MAGIC = F32(12582912.0)              # 0x1.8p23
MAGIC_BITS = 0x4B400000


def _fma32(x, y, z):
    """RN32(x * y + z) without intermediate rounding, for float32 arrays:
    the product is exact in float64, TwoSum makes the sum exact as hi + lo,
    and lo decides where hi falls on a midpoint of two float32s."""
    with np.errstate(over="ignore", invalid="ignore"):
        p = x.astype(F64) * y.astype(F64)
        zz = z.astype(F64)
        hi = p + zz
        bb = hi - p
        lo = (p - (hi - bb)) + (zz - bb)
        f = hi.astype(F32)
        other = np.nextafter(f, np.where(hi > f.astype(F64), F32(np.inf),
                                         F32(-np.inf)))
        mid = (f.astype(F64) + other.astype(F64)) * 0.5 == hi
        up = mid & (lo != 0) & ((lo > 0) ==
                                (other.astype(F64) > f.astype(F64)))
    return np.where(up, other, f)


def _sat_int(h):
    """uint32(int32(h)) as the kernel's __float2int_rz: saturating, NaN 0."""
    with np.errstate(invalid="ignore"):
        hi = np.clip(np.nan_to_num(h.astype(F64), nan=0.0), -2.0 ** 31,
                     2.0 ** 31 - 1).astype(np.int64)
    return (hi & 0xFFFFFFFF).astype(np.uint32)


def _kernel_divide_round(a, w):
    """(t, h, uint32(int32(h))) of a / w as the kernel computes them: the
    guarded reciprocal, the two-fma correction and the magic-number
    rounding, and the exact path where the fast t is not below 2^22."""
    with np.errstate(all="ignore"):
        aw = np.abs(w)
        y = np.where((aw >= F32(2.0 ** -60)) & (aw <= F32(2.0 ** 60)),
                     F32(1.0) / w, F32(np.nan)).astype(F32)
        q0 = (a * y).astype(F32)
        t = _fma32(-q0, w, a)
        t = _fma32(t, y, q0)
        fast = np.abs(t) < F32(2.0 ** 22)
        s = (t + MAGIC).astype(F32)
        h = (s - MAGIC).astype(F32)
        bits = (s.view(np.uint32).astype(np.int64) - MAGIC_BITS) & 0xFFFFFFFF
        t_slow = (a / w).astype(F32)
        h_slow = np.rint(t_slow).astype(F32)
    return (np.where(fast, t, t_slow), np.where(fast, h, h_slow),
            np.where(fast, bits.astype(np.uint32), _sat_int(h_slow)))


def _assert_like_division(a, w):
    """The model against np.float32 division and np.rint: h and its int32
    bitwise everywhere, t bitwise wherever |a / w| >= 2^-43; below that
    both are under 2^-26, where every bucket function is flat."""
    t, h, hi = _kernel_divide_round(a, w)
    with np.errstate(all="ignore"):
        t_ref = (a / w).astype(F32)
        h_ref = np.rint(t_ref)
    np.testing.assert_array_equal(hi, _sat_int(h_ref))
    np.testing.assert_array_equal(h, h_ref)            # NaNs at the same places
    tiny = np.abs(t_ref) < F32(2.0 ** -43)
    np.testing.assert_array_equal(t[~tiny], t_ref[~tiny])
    assert bool((np.abs(t[tiny]) < 2.0 ** -26).all())


def test_exact_fma_model_matches_fractions():
    """_fma32 against exact rational arithmetic on cancelling operands."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    x = rng.standard_normal(500).astype(F32)
    y = rng.standard_normal(500).astype(F32)
    z = (-(x.astype(F64) * y) * (1 + rng.standard_normal(500) * 1e-7)
         ).astype(F32)
    got = _fma32(x, y, z)
    for i in range(500):
        exact = Fraction(float(x[i])) * Fraction(float(y[i])) + \
            Fraction(float(z[i]))
        g = Fraction(float(got[i]))
        for nb in (np.nextafter(got[i], F32(np.inf)),
                   np.nextafter(got[i], F32(-np.inf))):
            # got is the nearest float32, and on a tie the even one
            d_g, d_n = abs(g - exact), abs(Fraction(float(nb)) - exact)
            assert d_g < d_n or (d_g == d_n and
                                 int(got[i].view(np.uint32)) % 2 == 0)


def test_kernel_division_random_operands():
    """About 10^5 random operands over a wide range of exponents and
    bit-uniform mantissas."""
    rng = np.random.default_rng(0)
    n = 100_000
    a = (rng.random(n) * 2 + 1) * 2.0 ** rng.integers(-30, 30, n)
    w = (rng.random(n) * 2 + 1) * 2.0 ** rng.integers(-30, 30, n)
    a = (a * rng.choice([-1, 1], n)).astype(F32)
    w = w.astype(F32)
    a[: n // 4] = rng.integers(0x3F800000, 0x40000000, n // 4,
                               dtype=np.uint32).view(F32)
    w[: n // 8] = rng.integers(0x3F800000, 0x40000000, n // 8,
                               dtype=np.uint32).view(F32)
    _assert_like_division(a, w)


def _near(v, k=3):
    """v and its k float32 neighbours on each side."""
    out = [F32(v)]
    lo = hi = F32(v)
    for _ in range(k):
        with np.errstate(over="ignore"):
            lo = np.nextafter(lo, F32(-np.inf))
            hi = np.nextafter(hi, F32(np.inf))
        out += [lo, hi]
    return out


def test_kernel_division_edge_operands():
    """Quotients at k + 1/2 +- 1 ulp, |t| around 2^22, 2^23 and 2^31, w
    near the smallest normal, the guard's 2^-60 and 2^60 and FLT_MAX, a
    subnormal, +-inf and NaN."""
    rng = np.random.default_rng(1)
    ws = np.concatenate([
        rng.gamma(2.0, 1.0, 40), [1.0, 0.5, 3.0, 1e-4, 7.0],
        _near(np.finfo(F32).tiny), _near(2.0 ** -60), _near(2.0 ** 60),
        _near(np.finfo(F32).max), [np.inf, -np.inf, np.nan, 0.0, -2.5]],
        dtype=F64).astype(F32)
    targets = []
    for k in (0, 1, 2, 7, 1000, 2 ** 20 + 1, 2 ** 21 + 3):
        for sgn in (1, -1):
            targets += _near(sgn * (k + 0.5))
    for v in (2.0 ** 22, 2.0 ** 23, 2.0 ** 31, 2.0 ** 22 - 0.5,
              2.0 ** 23 - 1.5, 2.0 ** 24, 1e38):
        targets += _near(v, 4) + _near(-v, 4)
    targets = np.array(targets, dtype=F32)
    with np.errstate(all="ignore"):
        a = (targets[:, None].astype(F64) * ws[None, :]).astype(F32)
    extra_a = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-42,
                        np.finfo(F32).tiny, np.finfo(F32).max, 1.0, -7.5],
                       dtype=F32)
    a = np.concatenate([a.ravel(), np.repeat(extra_a, ws.size)])
    w = np.concatenate([np.tile(ws, targets.size), np.tile(ws, extra_a.size)])
    _assert_like_division(a, w)


def _tie_sample():
    """W significands: the first and last 2^13 of [2^23, 2^24), and 2^13
    from a seed."""
    rng = np.random.default_rng(4)
    return torch.from_numpy(np.concatenate([
        np.arange(2 ** 23, 2 ** 23 + 2 ** 13),
        np.arange(2 ** 24 - 2 ** 13, 2 ** 24),
        rng.integers(2 ** 23, 2 ** 24, 2 ** 13)]).astype(np.int64))


def test_tie_adjacent_operands_lie_next_to_midpoints():
    """The card's exhaustive operands (repro_torch.testing.operands): a / w
    is M 2^-s + c / (W 2^s) for an odd 25-bit M, so within 5 / (Wo 2^24)
    of a midpoint of two float32s, Wo the odd part of W (a power-of-two w
    divides exactly); a and w in [1, 2)."""
    from repro_torch.testing.operands import tie_adjacent_quotients
    a, w = (v.numpy() for v in tie_adjacent_quotients(_tie_sample()))
    assert a.size > 5 * 3 * 2 ** 13
    assert ((a >= 1) & (a < 2) & (w >= 1) & (w < 2)).all()
    q = a.astype(F64) / w.astype(F64)
    lo = (a / w).astype(F32)
    lo = np.where(lo.astype(F64) > q, np.nextafter(lo, F32(0)), lo)
    mid = (lo.astype(F64) + np.nextafter(lo, F32(np.inf))) / 2
    W = (w.astype(F64) * 2.0 ** 23).astype(np.int64)
    Wo = W // (W & -W)
    assert (np.abs(q - mid) <= 5.0 / (Wo * 2.0 ** 24) + 2.0 ** -52).all()
    assert np.median(np.abs(q - mid)) < 2.0 ** -40


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 20, -(2.0 ** -30)])
def test_kernel_division_tie_adjacent_quotients(scale):
    """The model bitwise against IEEE division where the quotient lies next
    to a midpoint, so that the correction decides the rounding: a sample of
    the w significands the card check takes all of, a scaled to put t
    in [0.5, 2), around 2^20 (its ulp 1/8) and negative around 2^-30."""
    from repro_torch.testing.operands import tie_adjacent_quotients
    a, w = (v.numpy() for v in tie_adjacent_quotients(_tie_sample()))
    _assert_like_division((a * F32(scale)).astype(F32), w)


def test_kernel_division_unfaithful_first_product():
    """Operands where q0 = RN(a RN(1/w)) is not a faithful quotient (more
    than one ulp off, outside Markstein's hypothesis): 1/w near a midpoint
    and a's significand just below w's.  The corrected quotient still
    matches IEEE division bitwise."""
    rng = np.random.default_rng(5)
    W = rng.integers(2 ** 23, 2 ** 24, 2 ** 17)
    w = (W * 2.0 ** -23).astype(F32)
    y = (F32(1) / w).astype(F32)
    half_ulp = np.abs(np.nextafter(y, F32(0)).astype(F64) - y) / 2
    keep = np.abs(y.astype(F64) - 1.0 / w.astype(F64)) > 0.8 * half_ulp
    W, w, y = W[keep], w[keep], y[keep]
    A = np.concatenate([np.maximum(W - j, 2 ** 23) for j in range(1, 9)] +
                       [rng.integers(2 ** 23, W)])
    w, y = np.tile(w, 9), np.tile(y, 9)
    a = (A * 2.0 ** -23).astype(F32)
    q = a.astype(F64) / w.astype(F64)
    q0 = (a * y).astype(F32)
    lo = (a / w).astype(F32)
    lo = np.where(lo.astype(F64) > q, np.nextafter(lo, F32(0)), lo)
    unfaithful = (q0 != lo) & (q0 != np.nextafter(lo, F32(np.inf)))
    assert unfaithful.sum() > 1000
    _assert_like_division(a, w)


def _kernel_featurize_model(x, w, z, r1, r2, fname):
    """The kernel's (key1, key2, weight) for every (instance, point): its
    divide and rounding, the keys summed over the bits 0x4B400000 + int(h)
    less 0x4B400000 * sum_d r once, the weight a product in coordinate
    order."""
    f = tbf.get_bucket_fn(fname)
    m, d = w.shape
    keys1, keys2, weights = [], [], []
    for s in range(m):
        with np.errstate(all="ignore"):
            a = (x - z[s]).astype(F32)
        t, h, hi = _kernel_divide_round(a, np.broadcast_to(w[s], a.shape))
        sb = (hi.astype(np.uint64) + MAGIC_BITS) & 0xFFFFFFFF
        ks = []
        for r in (r1[s], r2[s]):
            acc = (sb * r.astype(np.uint64) & 0xFFFFFFFF).sum(1) & 0xFFFFFFFF
            corr = (int(r.astype(np.uint64).sum()) * MAGIC_BITS) & 0xFFFFFFFF
            ks.append(tlsh._fmix32(torch.from_numpy(
                ((acc - corr) & 0xFFFFFFFF).astype(np.int64))).numpy())
        with np.errstate(all="ignore"):
            fu = f(torch.from_numpy((h - t).astype(F32))).numpy()
        wt = fu[:, 0]
        for c in range(1, d):
            wt = (wt * fu[:, c]).astype(F32)
        keys1.append(ks[0])
        keys2.append(ks[1])
        weights.append(wt)
    return np.stack(keys1), np.stack(keys2), np.stack(weights)


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
def test_kernel_arithmetic_matches_plain_featurize(fname):
    """The whole per-element pipeline of the kernel, modelled in numpy,
    against the port's plain featurize (held against JAX above): keys
    bitwise, and the weight bitwise too, being the same product in the same
    order.  Inputs with large |t|, half-integer t and a w past 2^60."""
    x, w, z, r1, r2 = _inputs(21, 300, 7, 3)
    w[1, 3] = F32(2.0 ** 61)
    x[20, :] = np.inf
    k1, k2, wt = _kernel_featurize_model(x, w, z, r1, r2, fname)
    want = tlsh.featurize(tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu"),
                          tbf.get_bucket_fn(fname), x)
    np.testing.assert_array_equal(k1, want.key1.numpy().astype(np.int64))
    np.testing.assert_array_equal(k2, want.key2.numpy().astype(np.int64))
    np.testing.assert_array_equal(wt, want.weight.numpy())


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
def test_kernel_arithmetic_on_edge_operands(fname):
    """The kernel model on the edge operands the card tests and
    ``chip_smoke.py`` use, against the port's plain featurize, bitwise."""
    from repro_torch.testing.operands import featurize_edge_case
    x, w, z, r1, r2 = featurize_edge_case(5, 64, 6, 4)
    k1, k2, wt = _kernel_featurize_model(x, w, z, r1, r2, fname)
    want = tlsh.featurize(tlsh.lsh_params_from_numpy(w, z, r1, r2, "cpu"),
                          tbf.get_bucket_fn(fname), x)
    np.testing.assert_array_equal(k1, want.key1.numpy().astype(np.int64))
    np.testing.assert_array_equal(k2, want.key2.numpy().astype(np.int64))
    np.testing.assert_array_equal(wt, want.weight.numpy())


def test_edge_case_matches_jax_featurize():
    """The same edge operands through the JAX package and the port's plain
    path: keys and sign bitwise, weight to atol 2e-6."""
    from repro_torch.testing.operands import featurize_edge_case
    x, w, z, r1, r2 = featurize_edge_case(6, 40, 8, 3)
    got, want, want_slot = _both(x, w, z, r1, r2, "tent", 1 << 10)
    np.testing.assert_array_equal(got.key1.numpy(), np.asarray(want.key1))
    np.testing.assert_array_equal(got.key2.numpy(), np.asarray(want.key2))
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(want.sign))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want_slot))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=2e-6, rtol=0)
