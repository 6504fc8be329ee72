"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Torch-only (the machine with the card has no JAX), so run without the
repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every test needs a card and skips without one; whether a card exists is
decided in the ``cuda`` fixture, never at import.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.lsh import lsh_params_from_numpy
from repro_torch.data import make_regression
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.core import distributed as D
from repro_torch.kernels.binning import (bin_fused_matvec_cuda,
                                         bin_gather_blocked_cuda,
                                         bin_gather_cuda, bin_readout_cuda,
                                         bin_scatter_blocked_cuda,
                                         bin_scatter_cuda,
                                         fused_matvec_src_ref,
                                         gather_blocked_ref, gather_ref,
                                         readout_ref, route_pack_cuda,
                                         route_pack_ref, route_unpack_cuda,
                                         route_unpack_ref,
                                         scatter_blocked_ref, scatter_ref)
from repro_torch.kernels.binning import variants as V
from repro_torch.kernels.binning.kernel import (_bin_scatter, _readout_launch,
                                               scatter_plan)
from repro_torch.kernels.binning.ops import layout_rows
from repro_torch.kernels.featurize import featurize_cuda, featurize_ref
from repro_torch.testing.matvec_model import (fused_matvec_model,
                                              skewed_points, trap_layout)
from repro_torch.testing.scatter_model import (scatter_blocked_model,
                                               trap_layout_case)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(rng, m, d, device):
    """Random instances, with r near 2^32, half-integer t (w = 1, z = 0 on
    instance 0) and |t| past 2^31 (w = 1e-4 on instance m-1)."""
    w = rng.gamma(2.0, 1.0, (m, d)).astype(np.float32)
    z = (rng.random((m, d)) * w).astype(np.float32)
    w[0, :2], z[0, :2] = 1.0, 0.0
    w[-1, -2:] = 1e-4
    r1 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r2 = rng.integers(0, 2 ** 32, (m, d), dtype=np.uint64).astype(np.uint32)
    r1[0, 0] = r2[0, 0] = 2 ** 32 - 1
    return lsh_params_from_numpy(w, z, r1, r2, device)


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
@pytest.mark.parametrize("n,d,m", [(1000, 64, 9), (130, 3, 1), (257, 200, 4)])
def test_featurize_kernel_matches_plain(cuda, fname, n, d, m):
    rng = np.random.default_rng(n + d + m)
    p = _params(rng, m, d, cuda)
    x = (rng.random((n, d), dtype=np.float32) * 4.0 - 2.0)
    x[:8] *= 1e6                                   # large |h|
    x[8:16] = np.arange(8, dtype=np.float32)[:, None] - 3.5  # half-integers
    xt = torch.from_numpy(x).to(cuda)
    f = T.get_bucket_fn(fname)
    got = featurize_cuda(xt, *p, f=f, table_size=1 << 12)
    want = featurize_ref(xt, *p, f=f, table_size=1 << 12)
    torch.cuda.synchronize()
    for i, name in enumerate(("key1", "key2", "weight", "sign", "slot",
                              "coeff")):
        if name in ("weight", "coeff"):
            torch.testing.assert_close(got[i], want[i], atol=2e-6, rtol=0)
        else:
            assert torch.equal(got[i], want[i]), name


def _layout(rng, m, n, table_size, device):
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(device)
    slot[:, : n // 4] = 7                       # a heavy bucket
    coeff = torch.from_numpy(rng.standard_normal(
        (m, n), dtype=np.float32)).to(device)
    return T.build_blocked_layout(slot, coeff, table_size)


@pytest.mark.parametrize("k", [0, 1, 4, 40])
def test_fused_matvec_and_scatter_match_plain(cuda, k):
    """B2 (both output forms, beta in point order) and B3 against their
    plain versions within 1e-5 of max|out|, on a layout with a heavy
    bucket."""
    rng = np.random.default_rng(k)
    m, n, table_size = 5, 3000, 1 << 13
    lay = _layout(rng, m, n, table_size, cuda)
    beta = torch.from_numpy(rng.standard_normal(
        (n,) if k == 0 else (n, k), dtype=np.float32)).to(cuda)
    for totals in (False, True):
        got = bin_fused_matvec_cuda(lay.slot_lay, lay.coeff_lay, lay.src,
                                    beta, totals=totals)
        want = fused_matvec_src_ref(lay.slot_lay, lay.coeff_lay, lay.src,
                                    beta, totals=totals)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                                   rtol=1e-5)
    width = lay.num_tiles * lay.block_t
    contrib = layout_rows(lay, beta)
    contrib = (lay.coeff_lay * contrib if k == 0 else
               (lay.coeff_lay[..., None] * contrib).transpose(1, 2)
               .contiguous())
    tables = bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay, contrib,
                                      block_n=lay.block_n,
                                      block_t=lay.block_t)
    ref = scatter_blocked_ref(lay.slot_lay, contrib, width=width)
    torch.testing.assert_close(tables, ref, atol=1e-5 * ref.abs().max(),
                               rtol=1e-5)


def _within_summed_limit(got, plain, divide=1):
    """``got`` against ``plain(f)``, the plain version with f applied to
    its coefficients and beta, within phase 9's limit for kernels that
    sum: 1e-5 of max|out| plus 8 sqrt(terms) float32 roundings (2^-24) of
    each output's absolute sum (f = abs; terms from f = ones_like), the
    absolute sum divided by ``divide`` (m for a mean)."""
    want = plain(lambda t: t)
    abs_sum = plain(torch.abs).double() / divide
    terms = plain(torch.ones_like).double()
    lim = 1e-5 * float(want.abs().max()) + \
        8.0 * 2.0 ** -24 * abs_sum * terms.sqrt()
    assert got.shape == want.shape
    err = (got.double() - want.double()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())


def _skewed_index(kind, k, device):
    """(index with its layout, beta) for the B2 tests: the trap layout, or
    forest's skew (a few slots holding most of 100000 points an
    instance)."""
    rng = np.random.default_rng(k + 17)
    if kind == "trap":
        table_size = 1 << 12
        slot, coeff = trap_layout(rng, table_size=table_size, device=device)
    else:
        table_size = 1 << 18
        slot, coeff = skewed_points(rng, m=6, n=100000,
                                    table_size=table_size, device=device)
    idx = T.TableIndex(slot=slot, sign=coeff, weight=coeff, coeff=coeff,
                       table_size=table_size,
                       blocked=T.build_blocked_layout(slot, coeff,
                                                      table_size))
    n = slot.shape[1]
    beta = torch.from_numpy(rng.standard_normal(
        (n,) if k == 0 else (n, k), dtype=np.float32)).to(device)
    return idx, beta


def _bits(t):
    return t.contiguous().view(torch.int32).cpu().numpy()


@pytest.mark.parametrize("totals", [False, True])
@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("kind", ["trap", "forest_skew"])
def test_fused_matvec_is_deterministic_and_matches_model(cuda, kind, k,
                                                         totals):
    """B2 on the trap layout (one slot over several chunks followed by
    tile 0's padding, two slots, runs of a chunk's length and one less and
    one more, a run ending on a chunk's last position, zero coefficients)
    and at forest's skew: the same bits in two launches, bit for bit the
    numpy model of its sum order, and the plain version within phase 9's
    limit (runs of up to 74000 terms); float inputs."""
    idx, beta = _skewed_index(kind, k, cuda)
    lay = idx.blocked
    run = lambda: bin_fused_matvec_cuda(lay.slot_lay, lay.coeff_lay,
                                        lay.src, beta, totals=totals)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert np.array_equal(_bits(got), _bits(again))
    model = fused_matvec_model(lay.slot_lay.cpu(), lay.coeff_lay.cpu(),
                               lay.src.cpu(), beta.cpu().numpy(),
                               totals=totals)
    assert np.array_equal(_bits(got), model.view(np.int32))
    _within_summed_limit(got, lambda f: fused_matvec_src_ref(
        lay.slot_lay, f(lay.coeff_lay), lay.src, f(beta), totals=totals))


def _on_cpu(idx):
    """The index with the arrays the plain fused op reads on the CPU."""
    lay = idx.blocked._replace(**{
        f: getattr(idx.blocked, f).cpu()
        for f in ("inv_pos", "src", "slot_lay", "coeff_lay", "blk_start")})
    return idx._replace(slot=idx.slot.cpu(), coeff=idx.coeff.cpu(),
                        blocked=lay)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("k", [1, 4])
def test_fused_matvec_op_on_card_matches_cpu(cuda, k, average):
    """``bin_fused_matvec_op`` on the card (B2's run totals, then the
    readout over inv_pos) against the same op on the CPU (plain path),
    within phase 9's limit, at forest's skew and k columns."""
    from repro_torch.kernels.binning import bin_fused_matvec_op
    idx, b = _skewed_index("forest_skew", 0 if k == 1 else k, cuda)
    got = bin_fused_matvec_op(idx, b, average=average)
    cpu, bc = _on_cpu(idx), b.cpu()

    def plain(f):
        lay = cpu.blocked._replace(coeff_lay=f(cpu.blocked.coeff_lay))
        return bin_fused_matvec_op(cpu._replace(coeff=f(cpu.coeff),
                                                blocked=lay), f(bc),
                                   average=average and f is not
                                   torch.ones_like)
    _within_summed_limit(got.cpu(), plain, 1)


def test_fused_matvec_op_launches_b2_once_and_the_readout(cuda):
    """One op call on the card counts one B2 launch and one readout launch
    and no other kernel wrapper's; its device kernels are B2's three and
    the readout's (torch.profiler): no PyTorch kernel lays beta out or maps
    the result back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.binning import bin_fused_matvec_op
    idx, b = _skewed_index("trap", 0, cuda)
    bin_fused_matvec_op(idx, b)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bin_fused_matvec_op(idx, b)
        torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["bin_fused_matvec"] == 1 and counts["bin_readout"] == 1
    assert sum(counts.values()) == 2, counts
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    kinds = {next((k for k in ("mv_chunk_kernel", "mv_walk_kernel",
                               "mv_fix_kernel", "readout_kernel")
                   if k in name), name) for name in names}
    assert kinds == {"mv_chunk_kernel", "mv_walk_kernel", "mv_fix_kernel",
                     "readout_kernel"}, names


@pytest.mark.parametrize("k", [0, 1, 3])
def test_gather_is_bitwise(cuda, k):
    rng = np.random.default_rng(k)
    m, n, table_size = 6, 5000, 1 << 12
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(cuda)
    shape = (m, table_size) if k == 0 else (m, table_size, k)
    tables = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).to(cuda)
    assert torch.equal(bin_gather_cuda(slot, tables), gather_ref(slot, tables))


@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize("block_n", [128, 64])
def test_scatter_blocked_is_deterministic_and_matches_model(cuda, block_n,
                                                            k):
    """B3 on layouts with the run boundaries it must get right (tile 0's
    padding of slot 0 after higher slots, an empty tile, one slot holding
    a tile, a run across a chunk's end): the same bits in two launches,
    bit for bit the numpy model of its sum order, and within 1e-5 of
    max|out| of the plain version; float contributions."""
    rng = np.random.default_rng(block_n + k)
    slot, coeff = trap_layout_case(rng, block_n=block_n, device=cuda)
    lay = T.build_blocked_layout(slot, coeff, 1 << 12, block_n=block_n,
                                 block_t=512)
    shape = (lay.slot_lay.shape[0],) + ((k,) if k else ()) + (
        lay.slot_lay.shape[1],)
    beta = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(cuda)
    contrib = (lay.coeff_lay if k == 0 else lay.coeff_lay[:, None]) * beta
    run = lambda: bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay,
                                           contrib, block_n=block_n,
                                           block_t=512)
    got, again = run(), run()
    assert torch.equal(got, again)
    model = scatter_blocked_model(lay.blk_start.cpu(), lay.slot_lay.cpu(),
                                  contrib.cpu(), block_n=block_n,
                                  block_t=512)
    assert np.array_equal(got.cpu().numpy(), model)
    want = scatter_blocked_ref(lay.slot_lay, contrib,
                               width=lay.num_tiles * 512)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=0)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("m,n", [(5, 4096), (5, 1001), (1, 4096), (3, 1),
                                 (4, 0)])
@pytest.mark.parametrize("k", [0, 4])
def test_readout_matches_plain(cuda, k, m, n, average):
    """The fused readout against ``readout_ref`` within 1e-5 of max|out|
    (n a multiple of 4 takes the 4-point path, others the element path),
    and the same bits at every grouping of the instances and in two
    launches."""
    rng = np.random.default_rng(m * 7 + n + k)
    b = 1 << 12
    slot = torch.from_numpy(rng.integers(0, b, (m, n), dtype=np.int32)
                            ).to(cuda)
    coeff = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)
                             ).to(cuda)
    shape = (m, b) if k == 0 else (m, b, k)
    tables = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).to(cuda)
    got = bin_readout_cuda(slot, coeff, tables, average=average)
    want = readout_ref(slot, coeff, tables, average)
    assert got.shape == want.shape
    if n:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    for group in (1, 2, m):
        assert torch.equal(_readout_launch(slot, coeff, tables, average,
                                           group), got)


@pytest.mark.parametrize("precond", ["none", "jacobi", "nystrom"])
def test_fit_on_card_matches_cpu(cuda, precond):
    x, y, xq, _ = make_regression(2000, 300, 5, rough=0.3, seed=1)
    lsh = T.sample_lsh_params(np.random.default_rng(2), 16, 5, T.GammaPDF())
    spec = T.WLSHKernelSpec(bucket=T.RECT)
    kw = dict(lam=0.5, tol=1e-7, maxiter=300, precond=precond,
              precond_rank=64)
    reset_launch_counts()
    gpu = T.wlsh_krr_fit(lsh, x, y, spec, device=cuda, **kw)
    p_gpu = T.wlsh_krr_predict(gpu, xq, batch_size=128).cpu()
    counts = launch_counts()
    fit_path = ("featurize", "bin_fused_matvec", "bin_scatter_blocked",
                "bin_readout")
    assert all(counts[k] > 0 for k in fit_path), counts
    cpu = T.wlsh_krr_fit(lsh, x, y, spec, device="cpu", **kw)
    p_cpu = T.wlsh_krr_predict(cpu, xq)
    torch.testing.assert_close(p_gpu, p_cpu, atol=1e-4, rtol=0)


# B5 plans: many bins, chunks and groups in blocks of 64 threads; a ragged
# last bin at 600-byte tiles in blocks of 1024; several passes (windows of
# 3 bins, groups of at most 3 columns); the defaults (one bin for these
# tables)
SCATTER_PLANS = [dict(tile_bytes=512, stage_bytes=2048, scratch_bytes=40000,
                      threads=64),
                 dict(tile_bytes=600, stage_bytes=5000, threads=1024),
                 dict(tile_bytes=1024, stage_bytes=2048, max_bins=3,
                      max_cols=3),
                 dict()]


def _scatter(slot, contrib, table_size, plan_kw):
    """B5 at the plan ``plan_kw`` makes; the defaults through the public
    wrapper."""
    if not plan_kw:
        return bin_scatter_cuda(slot, contrib, table_size)
    m, n = slot.shape
    k = contrib.shape[2] if contrib.ndim == 3 else 1
    return _bin_scatter(slot, contrib, table_size,
                        scatter_plan(m, n, table_size, k, **plan_kw))


@pytest.mark.parametrize("plan_kw", SCATTER_PLANS)
@pytest.mark.parametrize("k", [0, 1, 4, 7])
def test_point_scatter_matches_plain(cuda, k, plan_kw):
    """B5: shared atomics, so the sum order varies: 1e-5 of max|out|, at
    several plans, with a heavy bucket; n = 4002 is no multiple of the
    chunk."""
    rng = np.random.default_rng(10 + k)
    m, table_size = 5, 1 << 12
    for n in (4000, 4002):
        slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                             dtype=np.int32)).to(cuda)
        slot[:, : n // 4] = 9                   # a heavy bucket
        shape = (m, n) if k == 0 else (m, n, k)
        contrib = torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(cuda)
        got = _scatter(slot, contrib, table_size, plan_kw)
        want = scatter_ref(slot, contrib, table_size=table_size)
        torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                                   rtol=1e-5)


@pytest.mark.parametrize("plan_kw", SCATTER_PLANS)
def test_point_scatter_heavy_slot(cuda, plan_kw):
    """B5 with 4096 points of each instance on one slot, the rest
    spread: 1e-5 of max|out|."""
    rng = np.random.default_rng(41)
    m, n, table_size = 8, 1 << 16, 1 << 17
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(cuda)
    slot[:, 1000:5096] = 12345
    contrib = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)
                               ).to(cuda)
    got = _scatter(slot, contrib, table_size, plan_kw)
    want = scatter_ref(slot, contrib, table_size=table_size)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=1e-5)


@pytest.mark.parametrize("table_size,k", [(1 << 23, 32), (1 << 20, 40),
                                          (1 << 28, 1)])
def test_point_scatter_wide_tables(cuda, table_size, k):
    """B5 where one pass does not hold the table: B = 2^23 at k = 32 (two
    windows of bins), k = 40 (two column groups), B = 2^28 at k = 1 (two
    windows); 1e-5 of max|out|."""
    rng = np.random.default_rng(42 + k)
    m, n = 2, 1 << 16
    plan = scatter_plan(m, n, table_size, k)
    assert plan.window < plan.bins or plan.cols < k
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(cuda)
    slot[:, :4096] = table_size - 1
    shape = (m, n) if k == 1 else (m, n, k)
    contrib = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                               ).to(cuda)
    got = bin_scatter_cuda(slot, contrib, table_size)
    want = scatter_ref(slot, contrib, table_size=table_size)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=1e-5)


def test_point_scatter_empty_and_single_bin(cuda):
    """B5 with no points writes zeros over the whole table; one point."""
    slot = torch.zeros((3, 0), dtype=torch.int32, device=cuda)
    got = bin_scatter_cuda(slot, torch.zeros((3, 0), device=cuda), 100000)
    assert torch.equal(got, torch.zeros((3, 100000), device=cuda))
    slot = torch.full((2, 1), 99999, dtype=torch.int32, device=cuda)
    got = bin_scatter_cuda(slot, torch.ones((2, 1), device=cuda), 100000)
    assert float(got.sum()) == 2.0 and float(got[:, 99999].sum()) == 2.0


@pytest.mark.parametrize("k", [0, 4])
def test_scatter_yardsticks_match_plain(cuda, k):
    """The first designs of B5 and B7, which phase 5 times beside the
    kernels."""
    rng = np.random.default_rng(70 + k)
    m, n, table_size = 5, 4000, 1 << 12
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(cuda)
    shape = (m, n) if k == 0 else (m, n, k)
    contrib = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                               ).to(cuda)
    want = scatter_ref(slot, contrib, table_size=table_size)
    tol = dict(atol=1e-5 * want.abs().max(), rtol=1e-5)
    torch.testing.assert_close(V.bin_scatter_v1_cuda(slot, contrib,
                                                     table_size), want, **tol)
    lay, cell_lay, nb, used, cap = _route(rng, cuda)
    cl = torch.from_numpy(rng.standard_normal(
        tuple(cell_lay.shape) + (() if k == 0 else (k,)),
        dtype=np.float32)).to(cuda)
    assert torch.equal(V.route_pack_v1_cuda(cell_lay, cl, nb),
                       route_pack_ref(cell_lay, cl, num_cells=nb))


@pytest.mark.parametrize("k", [0, 3])
def test_gather_blocked_is_bitwise(cuda, k):
    rng = np.random.default_rng(20 + k)
    lay = _layout(rng, 4, 3000, 1 << 12, cuda)
    shape = (4, 1 << 12) if k == 0 else (4, 1 << 12, k)
    tables = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).to(cuda)
    assert torch.equal(bin_gather_blocked_cuda(lay.slot_lay, tables),
                       gather_blocked_ref(lay.slot_lay, tables))


def _route(rng, device, n_shards=2, cap_factor=2.0, heavy=None):
    """One rank's routing at ``n_shards`` owners; ``heavy`` points (default
    a quarter) share slot 9."""
    m, table_size = 5, 1 << 12
    n = 3000 if heavy is None else heavy + 3000
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(device)
    slot[:, : n // 4 if heavy is None else heavy] = 9
    lay = T.build_blocked_layout(slot, torch.ones((m, n), device=device),
                                 table_size, block_n=64, parts="both")
    pt_cell, _, _, cap, _, _, used = D._routing_maps(
        slot, lay, n_shards, table_size, cap_factor)
    nb = n_shards * cap
    return lay, D._make_route_plan(pt_cell, lay, nb), nb, used, cap


@pytest.mark.parametrize("cap_factor", [2.0, 0.05])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_route_pack_and_unpack_are_bitwise(cuda, k, cap_factor):
    """B7 sums each cell's run in layout order, as its plain version does;
    B8 is one product per position: both bitwise, with dropped buckets
    (cap_factor 0.05) on the sentinel."""
    rng = np.random.default_rng(30 + k)
    lay, cell_lay, nb, used, cap = _route(rng, cuda, cap_factor=cap_factor)
    m, L = cell_lay.shape
    tail = () if k == 0 else (k,)
    contrib = torch.from_numpy(rng.standard_normal(
        (m, L) + tail, dtype=np.float32)).to(cuda)
    assert torch.equal(route_pack_cuda(cell_lay, contrib, used, cap),
                       route_pack_ref(cell_lay, contrib, num_cells=nb))
    back = torch.from_numpy(rng.standard_normal(
        (nb,) + tail, dtype=np.float32)).to(cuda)
    assert torch.equal(route_unpack_cuda(cell_lay, lay.coeff_lay, back),
                       route_unpack_ref(cell_lay, lay.coeff_lay, back))


@pytest.mark.parametrize("heavy", [None, 4096])
@pytest.mark.parametrize("cap_factor", [2.0, 0.05])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_route_pack_owners_and_bf16_are_bitwise(cuda, k, n_shards,
                                                cap_factor, heavy):
    """B7 at 1, 2 and 4 owners, with dropped buckets, and with a
    4096-point run: f32 bitwise with the plain pack, bf16 bitwise with the
    plain pack rounded by ``.to(bfloat16)``; a NaN contribution stays NaN
    in both."""
    rng = np.random.default_rng(50 + k + n_shards)
    lay, cell_lay, nb, used, cap = _route(rng, cuda, n_shards, cap_factor,
                                          heavy)
    m, L = cell_lay.shape
    tail = () if k == 0 else (k,)
    contrib = torch.from_numpy(rng.standard_normal(
        (m, L) + tail, dtype=np.float32)).to(cuda)
    contrib.view(-1)[7] = float("nan")
    want = route_pack_ref(cell_lay, contrib, num_cells=nb)
    got = route_pack_cuda(cell_lay, contrib, used, cap)
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.equal(got.isnan(), want.isnan())
    got16 = route_pack_cuda(cell_lay, contrib, used, cap,
                            out_dtype=torch.bfloat16)
    want16 = want.to(torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16.isnan(), want16.isnan())
    fin = ~want16.isnan()
    assert torch.equal(got16[fin].view(torch.int16),
                       want16[fin].view(torch.int16))


@pytest.mark.parametrize("k", [None, 2])
def test_hashjoin_send_bf16_on_card(cuda, k):
    """The hash join's bf16 send on the card (B7 rounding once) is bitwise
    the f32 plain pack cast by ``.to(bfloat16)``, at 2 owners."""
    rng = np.random.default_rng(60)
    lay, cell_lay, nb, used, cap = _route(rng, cuda, 2)
    n = lay.inv_pos.shape[1]
    beta = torch.from_numpy(rng.standard_normal(
        (n,) if k is None else (n, k), dtype=np.float32)).to(cuda)
    rt = D._Routing(cell_lay=cell_lay, recv_ids=None, serve_map=None, spp=0,
                    cap=cap, dropped=None, used=used)
    got = D._hashjoin_send(rt, lay, beta, torch.bfloat16)
    coeff = lay.coeff_lay if k is None else lay.coeff_lay[..., None]
    want = route_pack_ref(cell_lay, coeff * layout_rows(lay, beta),
                          num_cells=nb).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16),
                       want.view(got.shape).view(torch.int16))


def test_bad_arguments_raise(cuda):
    slot = torch.zeros((2, 10), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bin_gather_cuda(slot, torch.zeros((2, 16), device=cuda))
    with pytest.raises(ValueError):
        bin_readout_cuda(slot, torch.zeros((2, 10), device=cuda),
                         torch.zeros((2, 16), device=cuda))
    with pytest.raises(ValueError):   # coeff of another shape
        bin_readout_cuda(slot.int(), torch.zeros((2, 9), device=cuda),
                         torch.zeros((2, 16), device=cuda))
    with pytest.raises(ValueError):
        bin_scatter_cuda(slot.int(), torch.zeros((2, 11), device=cuda), 16)
    with pytest.raises(ValueError):
        route_unpack_cuda(slot.int(), torch.zeros((2, 10), device=cuda),
                          torch.zeros((4,), dtype=torch.float64,
                                      device=cuda))
    used = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):   # L % 4 != 0
        route_pack_cuda(slot[:, :9].int().contiguous(),
                        torch.zeros((2, 9), device=cuda), used, 4)
    with pytest.raises(ValueError):
        route_pack_cuda(slot.int()[:, :8].contiguous(),
                        torch.zeros((2, 8), device=cuda), used, 4,
                        out_dtype=torch.float16)
    lay9 = slot[:, :9].int().contiguous()
    with pytest.raises(ValueError):   # L % 4 != 0
        bin_fused_matvec_cuda(lay9, torch.zeros((2, 9), device=cuda), lay9,
                              torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):   # beta of another dtype
        bin_fused_matvec_cuda(lay9[:, :8].contiguous(),
                              torch.zeros((2, 8), device=cuda),
                              lay9[:, :8].contiguous(),
                              torch.zeros(3, dtype=torch.float64,
                                          device=cuda))
    with pytest.raises(ValueError):   # more shared memory than the card's
        _bin_scatter(slot.int(), torch.zeros((2, 10), device=cuda), 1 << 20,
                     scatter_plan(2, 10, 1 << 20, 1, tile_bytes=1 << 20))


# (B, KV, G, D, T): gemma3-1b, qwen3-14b, phi3-mini-3.8b, command-r-plus-104b
# kv-head shapes; T not a multiple of the 32-row tile, and T = 1; D = 64;
# one long cache (more splits than a cluster: combined through device
# memory)
DECODE_SHAPES = [(3, 1, 4, 256, 2112), (2, 8, 5, 128, 517),
                 (2, 32, 1, 96, 300), (2, 8, 12, 128, 1000), (4, 2, 3, 16, 1),
                 (2, 4, 8, 64, 700), (1, 1, 4, 256, 8191)]


@pytest.mark.parametrize("lens", ["random", "one", "wrapped", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,g,d,t", DECODE_SHAPES)
def test_flash_decode_matches_plain(cuda, b, kv, g, d, t, dtype, lens):
    """B9 against its plain version: random lengths, one valid row in the
    middle, a wrapped ring (all valid) and no valid row; 1e-5 of max|out|
    in f32, 1e-4 with a bf16 cache (f32 accumulation in both)."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    rng = np.random.default_rng(b * t + d)
    q = torch.from_numpy(rng.standard_normal((b, kv, g, d),
                                             dtype=np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((b, t, kv, d),
                                             dtype=np.float32)).to(cuda)
    v = torch.from_numpy(rng.standard_normal((b, t, kv, d),
                                             dtype=np.float32)).to(cuda)
    k, v = k.to(dtype), v.to(dtype)
    lengths = rng.integers(1, t + 1, (b, 1))
    valid = np.arange(t)[None] < lengths
    if lens == "one":
        valid = np.zeros((b, t), bool)
        valid[:, t // 2] = True
    elif lens == "wrapped":
        valid = np.ones((b, t), bool)
    elif lens == "none":
        valid = np.zeros((b, t), bool)
    valid = torch.from_numpy(valid.astype(np.int32)).to(cuda)
    for softcap in (0.0, 5.0):
        got = flash_decode_cuda(q, k, v, valid, softcap=softcap)
        want = flash_decode_ref(q, k, v, valid, softcap=softcap)
        torch.cuda.synchronize()
        lim = (1e-5 if dtype == torch.float32 else 1e-4) * float(
            want.abs().max())
        assert float((got - want).abs().max()) <= lim


def test_flash_decode_bad_arguments_raise(cuda):
    from repro_torch.kernels.flash_decode import flash_decode_cuda
    q = torch.zeros((1, 1, 17, 16), device=cuda)
    k = torch.zeros((1, 8, 1, 16), device=cuda)
    valid = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        flash_decode_cuda(q, k, k, valid)                  # G > 16
    with pytest.raises(ValueError):
        flash_decode_cuda(q[:, :, :4], k, k.bfloat16(), valid)  # mixed dtype
    with pytest.raises(ValueError):
        flash_decode_cuda(q[:, :, :4], k, k, valid.long())
    with pytest.raises(ValueError):                        # D % 8 != 0
        flash_decode_cuda(q[:, :, :4, :12].contiguous(),
                          k[..., :12].contiguous(), k[..., :12].contiguous(),
                          valid)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-14b"])
def test_decode_on_card_matches_cpu(cuda, arch):
    """prefill + 6 decode steps of the smoke config on the card against the
    same on the CPU (the same weights); B9 launched once per layer per step."""
    from repro_torch.configs import registry
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_map
    cfg = registry.smoke_config(arch)
    params = TM.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 14))).long()
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev), params)
        tk = toks.to(dev)
        reset_launch_counts()
        logits, cache, pos = TM.prefill(cfg, p, {"tokens": tk[:, :8]},
                                        max_cache_len=14, dtype=torch.float32)
        steps = [logits]
        for t in range(8, 14):
            logits, cache = TM.decode_step(cfg, p, cache, tk[:, t:t + 1], pos,
                                           dtype=torch.float32)
            pos = pos + 1
            steps.append(logits)
        out[str(dev)] = torch.stack(steps).cpu()
        if dev != "cpu":
            assert launch_counts()["flash_decode"] == 6 * cfg.n_layers
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4 * scale,
                               rtol=0)


@pytest.mark.parametrize("fname", ["rect", "tent", "smooth"])
def test_featurize_kernel_on_edge_operands(cuda, fname):
    """B1's fast divide and rounding where they hand over to the exact path
    (NaN, +-inf, |t| at and past 2^22, w past 2^-60 and 2^60) and at ties:
    keys, slot and sign bitwise, weight and coeff to 2e-6, at full width."""
    from repro_torch.testing.operands import featurize_edge_case
    x, w, z, r1, r2 = featurize_edge_case(3, 4099, 64, 64)
    p = lsh_params_from_numpy(w, z, r1, r2, cuda)
    xt = torch.from_numpy(x).to(cuda)
    f = T.get_bucket_fn(fname)
    got = featurize_cuda(xt, *p, f=f, table_size=1 << 23)
    want = featurize_ref(xt, *p, f=f, table_size=1 << 23)
    torch.cuda.synchronize()
    for i, name in enumerate(("key1", "key2", "weight", "sign", "slot",
                              "coeff")):
        if name in ("weight", "coeff"):
            torch.testing.assert_close(got[i], want[i], atol=2e-6, rtol=0)
        else:
            assert torch.equal(got[i], want[i]), name


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 20, -(2.0 ** -30)])
def test_featurize_quotient_every_significand(cuda, scale):
    """B1's fast-path quotient (its device function, run alone) bitwise
    against IEEE division at quotients next to a midpoint of two float32s,
    for every one of the 2^23 significands of w."""
    from repro_torch.kernels.featurize.kernel import fast_quotient_cuda
    from repro_torch.testing.operands import tie_adjacent_quotients
    a, w = tie_adjacent_quotients(torch.arange(1 << 23, 1 << 24,
                                               device=cuda))
    a = a * scale
    got = fast_quotient_cuda(a, w)
    assert a.numel() > 5 * 2 ** 23
    assert torch.equal(got.view(torch.int32), (a / w).view(torch.int32))


@pytest.mark.parametrize("b,t", [(8, 512), (8, 2112), (1, 8191)])
def test_flash_decode_twice_and_on_two_streams(cuda, b, t):
    """gemma3-1b's decode shapes (B 8, KV 1, G 4, D 256, f32; the splits of
    a cache combined within a cluster) and one long cache (more splits:
    combined by the last block to arrive, through device memory), called
    twice in a row and then on two streams, each within 1e-5 of max|out|;
    the arrival counters are back at 0 after every call."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    from repro_torch.kernels.flash_decode import kernel as K
    gen = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn((b, 1, 4, 256), generator=gen, device=cuda)
    k = torch.randn((b, t, 1, 256), generator=gen, device=cuda)
    v = torch.randn((b, t, 1, 256), generator=gen, device=cuda)
    lens = torch.randint(1, t + 1, (b, 1), generator=gen, device=cuda)
    valid = (torch.arange(t, device=cuda)[None] < lens).to(torch.int32)
    tile_rows, slots = K.kernel_geometry(cuda, 4, 256, False)
    n_split = K.split_plan(b, 1, t, slots, tile_rows)[0]
    assert n_split > 1 and (n_split > K.MAX_CLUSTER) == (b == 1)
    want = flash_decode_ref(q, k, v, valid)
    lim = 1e-5 * float(want.abs().max())
    outs = [flash_decode_cuda(q, k, v, valid) for _ in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(flash_decode_cuda(q, k, v, valid))
    torch.cuda.synchronize()
    for out in outs:
        assert float((out - want).abs().max()) <= lim
    counters = [c for (dev, _), c in K._counters.items()
                if dev == want.device.index]
    assert all(int(c.abs().sum()) == 0 for c in counters)
    if b == 1:
        assert len(counters) >= 3


@pytest.mark.parametrize("t", [1001, 4096])
def test_flash_decode_bf16_tensor_core_path(cuda, t):
    """qwen3-14b's kv-head shape (KV 8, G 5, D 128) with a bf16 cache runs
    the warp-MMA kernel (64-row tiles); within 1e-4 of max|out| for random
    lengths and a cache with one valid row."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    from repro_torch.kernels.flash_decode import kernel as K
    assert K.kernel_geometry(cuda, 5, 128, True)[0] == 64
    gen = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn((4, 8, 5, 128), generator=gen, device=cuda)
    k = torch.randn((4, t, 8, 128), generator=gen, device=cuda).bfloat16()
    v = torch.randn((4, t, 8, 128), generator=gen, device=cuda).bfloat16()
    lens = torch.randint(1, t + 1, (4, 1), generator=gen, device=cuda)
    for valid in ((torch.arange(t, device=cuda)[None] < lens),
                  torch.arange(t, device=cuda)[None].expand(4, -1) == t // 3):
        valid = valid.to(torch.int32).contiguous()
        for softcap in (0.0, 5.0):
            got = flash_decode_cuda(q, k, v, valid, softcap=softcap)
            want = flash_decode_ref(q, k, v, valid, softcap=softcap)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= 1e-4 * float(
                want.abs().max())


def _served_model(cuda, tmp_path, norm=None):
    """A small fit on the card, exported and loaded into a Predictor on the
    card (max_batch 64); returns (predictor, model, query rows)."""
    from repro_torch.serve import Predictor, export_artifact
    rng = np.random.default_rng(11)
    n, d, m = 4096, 16, 32
    x = rng.uniform(0.0, 2.0, (n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device=cuda)
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT),
                           lam=0.5, maxiter=20, device=cuda)
    export_artifact(str(tmp_path / "art"), model, norm=norm)
    pred = Predictor(device=cuda, max_batch=64)
    pred.load(str(tmp_path / "art"))
    xq = rng.uniform(0.0, 2.0, (300, d)).astype(np.float32)
    return pred, model, xq


def test_predictor_captures_one_graph_per_bucket(cuda, tmp_path):
    """warmup captures the seven buckets of max_batch 64, each recording
    one B1 and one readout call, which the capture does not count; ragged
    and over-size requests capture nothing more and replay the graphs, and
    each replay counts its recorded launches."""
    pred, _, xq = _served_model(cuda, tmp_path)
    reset_launch_counts()
    assert pred.warmup() == 7
    # the eager run before each capture launches for real; the capture not
    assert launch_counts()["featurize"] == 7
    stats = pred.graph_stats()
    assert sorted(stats) == [1, 2, 4, 8, 16, 32, 64]
    for b, g in stats.items():
        assert g["launches"] == {"featurize": 1, "bin_readout": 1}
        assert g["launches_by_shape"]["featurize"] == {(b, 16, 32): 1}
    reset_launch_counts()
    for b in (1, 3, 17, 33, 64, 65, 300):
        pred.predict(xq[:b])
    assert pred.compile_count() == 7
    # one replay a request up to 64 rows; 65 rows in 64 + 1, 300 in
    # 4 x 64 + 44
    assert sum(g["replays"] for g in pred.graph_stats().values()) == 12
    counts = launch_counts()
    assert counts["featurize"] == counts["bin_readout"] == 12
    assert sum(counts.values()) == 24


def test_graph_replay_bitwise_equals_eager_path(cuda, tmp_path):
    """Every bucket's replay gives the bits of ``wlsh_krr_predict`` on the
    same rows (rows are independent: padding changes none), with and
    without normalization (eager normalize -> predict -> denormalize)."""
    from repro_torch.serve import Normalization
    d = 16
    norm = Normalization(x_mean=np.full((d,), 0.25, np.float32),
                         x_std=np.full((d,), 1.5, np.float32),
                         y_mean=0.5, y_std=2.0)
    for nm in (None, norm):
        pred, model, xq = _served_model(cuda, tmp_path / str(nm is None),
                                        norm=nm)
        for b in (1, 2, 5, 8, 13, 32, 64, 200):
            got = pred.predict(xq[:b], use_cache=False)
            xin = xq[:b] if nm is None else (xq[:b] - np.float32(0.25)) \
                / np.float32(1.5)
            want = T.wlsh_krr_predict(model, xin).cpu().numpy()
            if nm is not None:
                want = want * np.float32(2.0) + np.float32(0.5)
            np.testing.assert_array_equal(got, want)


def test_concurrent_predicts_from_four_threads(cuda, tmp_path):
    """Four threads predict ragged batches against one model at once: the
    per-model lock keeps each graph's buffers to one request at a time, so
    every answer is the bits of the serial answer."""
    import threading
    pred, _, xq = _served_model(cuda, tmp_path)
    pred.warmup()
    sizes = (1, 3, 7, 16, 40, 64)
    want = {b: pred.predict(xq[:b], use_cache=False) for b in sizes}
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            b = int(rng.choice(sizes))
            if not np.array_equal(pred.predict(xq[:b], use_cache=False),
                                  want[b]):
                errors.append(b)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert pred.compile_count() == 7


def test_unloaded_model_releases_its_graphs(cuda, tmp_path):
    """After unload, the model's graphs, static buffers and tables are
    released: device memory in use falls back below its hosted level."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    pred, model, xq = _served_model(cuda, tmp_path)
    del model
    pred.warmup()
    pred.predict(xq[:5])
    hosted = torch.cuda.memory_allocated()
    assert pred.unload("art")
    torch.cuda.synchronize()
    released = torch.cuda.memory_allocated()
    assert released < hosted and released <= base + (1 << 20)


@pytest.mark.parametrize("n,d,m", [(5000, 5, 16), (1 << 16, 64, 8)])
def test_exact_index_and_matvec_on_card_match_cpu(cuda, n, d, m):
    """Exact mode on the card: the index from B1's features bitwise the
    CPU's (the keys made equal ties common), the matvec within 1e-5 of
    max|out| at k = 1 and 4 (index_add_ adds in another order)."""
    rng = np.random.default_rng(n + d)
    p = _params(rng, m, d, cuda)
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(cuda)
    feats = T.Features(*featurize_cuda(x, *p, f=T.RECT,
                                       table_size=1 << 12)[:4])
    cpu = T.Features(*(t.cpu() for t in feats[:4]))
    got, want = T.build_exact_index(feats), T.build_exact_index(cpu)
    assert torch.equal(got.perm.cpu(), want.perm)
    assert torch.equal(got.seg_id.cpu(), want.seg_id)
    for k in (None, 4):
        beta = torch.from_numpy(rng.standard_normal(
            (n,) if k is None else (n, k), dtype=np.float32))
        out = T.exact_matvec(got, beta.to(cuda)).cpu()
        ref = T.exact_matvec(want, beta)
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


def test_exact_mode_fit_on_card_matches_cpu(cuda):
    """wlsh_krr_fit(mode='exact') on the card (B1, B5, the readout) against
    the same fit on the CPU, both solved to tol 1e-7: predictions within
    1e-4 of max|pred|."""
    x, y, xq, _ = make_regression(3000, 500, 5, rough=0.3, seed=3)
    rng = np.random.default_rng(3)
    lsh = T.sample_lsh_params(rng, 64, 5, T.GammaPDF(7.0, 1.0), 1.5)
    spec = T.WLSHKernelSpec(bucket=T.SMOOTH, pdf=T.GammaPDF(7.0, 1.0))
    reset_launch_counts()
    card = T.wlsh_krr_fit(lsh.to(cuda), x, y, spec, lam=0.5, mode="exact",
                          tol=1e-7, precond="jacobi", device=cuda)
    pc = T.wlsh_krr_predict(card, xq).cpu()
    counts = launch_counts()
    assert counts["featurize"] >= 2 and counts["bin_scatter"] == 1
    assert counts["bin_readout"] == 1
    host = T.wlsh_krr_fit(lsh, x, y, spec, lam=0.5, mode="exact",
                          tol=1e-7, precond="jacobi", device="cpu")
    ph = T.wlsh_krr_predict(host, xq)
    torch.testing.assert_close(pc, ph, rtol=0,
                               atol=1e-4 * float(ph.abs().max()))
