"""The frozen counts against a count by hand at a tiny shape, and their
bounds at the wlsh_krr shapes beside the ones chip_smoke.py's phase 5
printed (which count the port's own tensors: the slot-sorted layout, its
padding, every output of B1)."""
import numpy as np
import pytest

from port_bench.counts import featurize, fit, matvec, predict, readout, tables

TINY = dict(m=3, dim=5, n_points=7, table_size=16)
H100 = dict(bytes_per_s=3.35e12, f32_flops_per_s=6.7e13)
WLSH_KRR = dict(m=64, dim=64, n_points=1 << 22, table_size=1 << 23)
# chip_smoke.py phase 5's bounds at n = 2^22 (PERF.md's kernel table)
PHASE5_MS = {"B1 featurize": 2.244, "B2 matvec": 1.928}


def nbytes(*shapes):
    """Bytes of float32 / int32 arrays of these shapes."""
    return sum(np.zeros(s, np.float32).nbytes for s in shapes)


class Ops:
    """Counts the float operations of a loop written out by hand."""

    def __init__(self):
        self.n = 0

    def __call__(self, k=1):
        self.n += k


def by_hand_matvec(m, n):
    ops = Ops()
    for _s in range(m):
        for _i in range(n):
            ops(2)        # coeff * v[i], added into its slot's table entry
        for _i in range(n):
            ops(2)        # coeff * table[slot], added into out[i]
    return ops.n, nbytes((m, n), (m, n), (n,), (n,))  # slot, coeff, v, out


def by_hand_featurize(m, d, rows):
    ops = Ops()
    for _s in range(m):
        for _i in range(rows):
            for _l in range(d):
                ops(5)    # x - z, / w, round, h - t, weight *= f
    return ops.n, nbytes((rows, d), (m, d), (m, d), (m, d), (m, d),
                         (m, rows), (m, rows))          # slot, coeff out


def by_hand_readout(m, rows):
    ops = Ops()
    for _s in range(m):
        for _i in range(rows):
            ops(2)        # coeff * table[slot], added into the sum
    # slot, coeff, the predictions (the table entries, which a skewed
    # layout reads from cache, are no part of the floor)
    return ops.n, nbytes((m, rows), (m, rows), (rows,))


def test_featurize_by_hand():
    flops, b = by_hand_featurize(3, 5, 11)
    assert featurize.cost(TINY, 11) == {"flops": flops, "bytes": b}


def test_matvec_by_hand():
    flops, b = by_hand_matvec(3, 7)
    assert matvec.cost(TINY) == {"flops": flops, "bytes": b}


def test_readout_by_hand():
    flops, b = by_hand_readout(3, 9)
    assert readout.cost(TINY, 9) == {"flops": flops, "bytes": b}


def test_tables_by_hand():
    # slot, coeff and beta read; the (m, B) tables written; a product and
    # an add an (instance, point)
    assert tables.cost(TINY) == {
        "flops": 2 * 3 * 7,
        "bytes": nbytes((3, 7), (3, 7), (7,), (3, 16))}


@pytest.mark.parametrize("iters", [0, 1, 32])
def test_whole_fit_and_predict(iters):
    f, b = by_hand_featurize(3, 5, 7)
    mv_f, mv_b = by_hand_matvec(3, 7)
    got = fit.cost(TINY, iters)
    assert got["flops"] == f + iters * mv_f + 2 * 3 * 7
    assert got["bytes"] == b + iters * mv_b + tables.cost(TINY)["bytes"]
    rf, rb = by_hand_readout(3, 13)
    f, b = by_hand_featurize(3, 5, 13)
    assert predict.cost(TINY, 13) == {"flops": f + rf, "bytes": b + rb}


def bound_ms(cost):
    return 1e3 * max(cost["bytes"] / H100["bytes_per_s"],
                     cost["flops"] / H100["f32_flops_per_s"])


def test_bounds_beside_phase5():
    mine = {"B1 featurize": bound_ms(featurize.cost(WLSH_KRR, 1 << 22)),
            "B2 matvec": bound_ms(matvec.cost(WLSH_KRR))}
    for name, ms in mine.items():
        print(f"{name} at n = 2^22: frozen count {ms:.3f} ms, "
              f"phase 5 {PHASE5_MS[name]:.3f} ms")
        # phase 5 counts more than the work needs, never less
        assert ms < PHASE5_MS[name]
    assert mine["B2 matvec"] == pytest.approx(0.651, abs=1e-3)
    assert mine["B1 featurize"] == pytest.approx(1.282, abs=1e-3)
