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
                                         bin_gather_cuda,
                                         bin_scatter_blocked_cuda,
                                         bin_scatter_cuda, fused_matvec_ref,
                                         gather_blocked_ref, gather_ref,
                                         route_pack_cuda, route_pack_ref,
                                         route_unpack_cuda, route_unpack_ref,
                                         scatter_blocked_ref, scatter_ref)
from repro_torch.kernels.featurize import featurize_cuda, featurize_ref

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
    rng = np.random.default_rng(k)
    m, n, table_size = 5, 3000, 1 << 13
    lay = _layout(rng, m, n, table_size, cuda)
    shape = (m, lay.slot_lay.shape[1]) if k == 0 else \
        (m, k, lay.slot_lay.shape[1])
    beta = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(cuda)
    real = (lay.coeff_lay != 0).to(beta.dtype)       # padding reads beta 0
    beta = beta * (real if k == 0 else real[:, None, :])
    width = lay.num_tiles * lay.block_t
    got = bin_fused_matvec_cuda(lay.blk_start, lay.slot_lay, lay.coeff_lay,
                                beta, block_n=lay.block_n,
                                block_t=lay.block_t)
    want = fused_matvec_ref(lay.slot_lay, lay.coeff_lay, beta, width=width)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=1e-5)
    tables = bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay, beta,
                                      block_n=lay.block_n,
                                      block_t=lay.block_t)
    ref = scatter_blocked_ref(lay.slot_lay, beta, width=width)
    torch.testing.assert_close(tables, ref, atol=1e-5 * ref.abs().max(),
                               rtol=1e-5)


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
                "bin_gather")
    assert all(counts[k] > 0 for k in fit_path), counts
    cpu = T.wlsh_krr_fit(lsh, x, y, spec, device="cpu", **kw)
    p_cpu = T.wlsh_krr_predict(cpu, xq)
    torch.testing.assert_close(p_gpu, p_cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k", [0, 1, 4])
def test_point_scatter_matches_plain(cuda, k):
    """B5: global atomics, so the sum order varies: 1e-5 of max|out|."""
    rng = np.random.default_rng(10 + k)
    m, n, table_size = 5, 4000, 1 << 12
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(cuda)
    slot[:, : n // 4] = 9                       # a heavy bucket
    shape = (m, n) if k == 0 else (m, n, k)
    contrib = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                               ).to(cuda)
    got = bin_scatter_cuda(slot, contrib, table_size)
    want = scatter_ref(slot, contrib, table_size=table_size)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max(),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [0, 3])
def test_gather_blocked_is_bitwise(cuda, k):
    rng = np.random.default_rng(20 + k)
    lay = _layout(rng, 4, 3000, 1 << 12, cuda)
    shape = (4, 1 << 12) if k == 0 else (4, 1 << 12, k)
    tables = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).to(cuda)
    assert torch.equal(bin_gather_blocked_cuda(lay.slot_lay, tables),
                       gather_blocked_ref(lay.slot_lay, tables))


def _route(rng, device, n_shards=2, cap_factor=2.0):
    m, n, table_size = 5, 3000, 1 << 12
    slot = torch.from_numpy(rng.integers(0, table_size, (m, n),
                                         dtype=np.int32)).to(device)
    slot[:, : n // 4] = 9
    lay = T.build_blocked_layout(slot, torch.ones((m, n), device=device),
                                 table_size, block_n=64, parts="both")
    pt_cell, _, _, cap, _, _ = D._routing_maps(slot, lay, n_shards,
                                               table_size, cap_factor)
    nb = n_shards * cap
    return lay, D._make_route_plan(pt_cell, lay, nb), nb


@pytest.mark.parametrize("cap_factor", [2.0, 0.05])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_route_pack_and_unpack_are_bitwise(cuda, k, cap_factor):
    """B7 sums each cell's run in layout order, as its plain version does;
    B8 is one product per position: both bitwise, with dropped buckets
    (cap_factor 0.05) on the sentinel."""
    rng = np.random.default_rng(30 + k)
    lay, cell_lay, nb = _route(rng, cuda, cap_factor=cap_factor)
    m, L = cell_lay.shape
    tail = () if k == 0 else (k,)
    contrib = torch.from_numpy(rng.standard_normal(
        (m, L) + tail, dtype=np.float32)).to(cuda)
    assert torch.equal(route_pack_cuda(cell_lay, contrib, nb),
                       route_pack_ref(cell_lay, contrib, num_cells=nb))
    back = torch.from_numpy(rng.standard_normal(
        (nb,) + tail, dtype=np.float32)).to(cuda)
    assert torch.equal(route_unpack_cuda(cell_lay, lay.coeff_lay, back),
                       route_unpack_ref(cell_lay, lay.coeff_lay, back))


def test_bad_arguments_raise(cuda):
    slot = torch.zeros((2, 10), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bin_gather_cuda(slot, torch.zeros((2, 16), device=cuda))
    with pytest.raises(ValueError):
        bin_scatter_cuda(slot.int(), torch.zeros((2, 11), device=cuda), 16)
    with pytest.raises(ValueError):
        route_unpack_cuda(slot.int(), torch.zeros((2, 10), device=cuda),
                          torch.zeros((4,), dtype=torch.float64,
                                      device=cuda))
