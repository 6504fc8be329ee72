"""Hash-join routing of the port against the JAX package on the CPU: the
routing maps, the wire-cell layout and the route schedule bitwise, the
order of the wire cells that B8 is sized on, the plain versions of the
route kernels B7/B8 against the Pallas kernels in interpret mode and B8's
against a numpy oracle on cells out of that order, the bf16 wire cast
bitwise, and no sort in the routing build."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import _make_route_plan as j_route_plan
from repro.core.distributed import _routing_maps as j_routing_maps
from repro.core.wlsh import build_blocked_layout as j_layout
from repro.kernels.binning import route_pack_pallas, route_unpack_pallas
from repro_torch.core import distributed as D
from repro_torch.core.wlsh import (BLOCKED_SPLIT_N, BLOCKED_SPLIT_T,
                                   build_blocked_layout,
                                   build_route_schedule)
from repro_torch.kernels.binning import route_pack_ref, route_unpack_ref
from repro_torch.testing.route_cases import (UNPACK_KS, UNPACK_LS,
                                             UNPACK_MS, unpack_bits,
                                             unpack_case, unpack_oracle)


def _setup(m=3, n=200, table_size=1024, n_shards=2, cap_factor=2.0, seed=9):
    """Slots with a heavy bucket, both frameworks' layouts (split geometry,
    both groups) and routing maps."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, table_size, (m, n)).astype(np.int32)
    slot[:, :20] = 5
    coeff = rng.standard_normal((m, n)).astype(np.float32)
    jlay = j_layout(jnp.asarray(slot), jnp.asarray(coeff), table_size,
                    block_n=BLOCKED_SPLIT_N, block_t=BLOCKED_SPLIT_T,
                    parts="both")
    tlay = build_blocked_layout(torch.from_numpy(slot),
                                torch.from_numpy(coeff), table_size,
                                block_n=BLOCKED_SPLIT_N,
                                block_t=BLOCKED_SPLIT_T, parts="both")
    jmaps = j_routing_maps(jnp.asarray(slot), jlay, n_shards, table_size,
                           cap_factor)
    tmaps = D._routing_maps(torch.from_numpy(slot), tlay, n_shards,
                            table_size, cap_factor)
    return jlay, tlay, jmaps, tmaps, coeff


@pytest.mark.parametrize("cap_factor", [2.0, 0.05])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_routing_maps_are_bitwise(n_shards, cap_factor):
    """pt_cell, send_packed, spp, cap, dropped and owner_max as the JAX
    package computes them (cap_factor 0.05 forces overflow drops)."""
    _, _, jmaps, tmaps, _ = _setup(n_shards=n_shards, cap_factor=cap_factor)
    names = ("pt_cell", "send_packed", "spp", "cap", "dropped", "owner_max")
    for name, j, t in zip(names, jmaps, tmaps):
        if isinstance(j, int):
            assert t == j, name
        else:
            assert t.dtype == torch.int32, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
    if cap_factor < 1:
        assert int(tmaps[4]) > 0


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_route_plan_and_schedule_are_bitwise(n_shards):
    """The wire-cell layout of the route plan, and the pack/unpack visit
    schedule built from it, as the JAX package builds them."""
    jlay, tlay, jmaps, tmaps, _ = _setup(n_shards=n_shards)
    nb = n_shards * tmaps[3]
    jplan = j_route_plan(jmaps[0], jlay, nb)
    cell_lay = D._make_route_plan(tmaps[0], tlay, nb)
    assert cell_lay.dtype == torch.int32
    np.testing.assert_array_equal(cell_lay.numpy(),
                                  np.asarray(jplan.cell_lay))
    sched = build_route_schedule(cell_lay,
                                 num_cell_tiles=jplan.sched.num_cell_tiles,
                                 block_n=tlay.block_n,
                                 block_t=jplan.sched.block_t)
    for name in sched._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sched, name)),
                                      np.asarray(getattr(jplan.sched, name)),
                                      err_msg=name)


def test_routing_build_has_no_sort(monkeypatch):
    """The routing maps, the cell layout and the schedule are cumsums and
    searchsorted only: the step's one sort is the layout's."""
    slot = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1024, (3, 200)).astype(np.int32))
    lay = build_blocked_layout(slot, torch.ones(3, 200), 1024,
                               block_n=BLOCKED_SPLIT_N,
                               block_t=BLOCKED_SPLIT_T, parts="both")

    def no_sort(*a, **k):
        raise AssertionError("sort called in the routing build")

    for name in ("sort", "argsort", "msort"):
        monkeypatch.setattr(torch, name, no_sort)
    monkeypatch.setattr(torch.Tensor, "sort", no_sort)
    monkeypatch.setattr(torch.Tensor, "argsort", no_sort)
    pt_cell, _, _, cap, _, _, _ = D._routing_maps(slot, lay, 4, 1024, 2.0)
    cell_lay = D._make_route_plan(pt_cell, lay, 4 * cap)
    build_route_schedule(cell_lay, num_cell_tiles=-(-4 * cap // 512),
                         block_n=lay.block_n, block_t=512)


def _contrib_layout(tlay, beta):
    """beta (n,) or (n, k) as contributions along the layout: (m, L[, k])
    for the port, (m, L) or (m, k, L) for the Pallas kernel."""
    pad = np.zeros((1,) + beta.shape[1:], np.float32)
    lay_vals = np.concatenate([beta, pad])[tlay.src.numpy()]
    coeff = tlay.coeff_lay.numpy()
    port = (coeff * lay_vals if beta.ndim == 1
            else coeff[..., None] * lay_vals)
    return port, (port if beta.ndim == 1 else np.swapaxes(port, 1, 2))


@pytest.mark.parametrize("k", [None, 1, 4])
def test_route_pack_plain_matches_pallas(k):
    """B7's plain version against ``route_pack_pallas`` in interpret mode.
    The Pallas kernel sums a cell's run as a one-hot product (another
    association than the run's sequential sum): equal to 1e-6 of the
    largest cell."""
    jlay, tlay, jmaps, tmaps, _ = _setup()
    nb = 2 * tmaps[3]
    jplan = j_route_plan(jmaps[0], jlay, nb)
    cell_lay = D._make_route_plan(tmaps[0], tlay, nb)
    rng = np.random.default_rng(4)
    beta = rng.standard_normal((200,) if k is None else (200, k)
                               ).astype(np.float32)
    port, pallas = _contrib_layout(tlay, beta)
    s = jplan.sched
    packed = np.asarray(route_pack_pallas(
        s.p_inst, s.p_block, s.p_tile, s.p_flag, jplan.cell_lay,
        jnp.asarray(pallas), num_cell_tiles=s.num_cell_tiles,
        block_n=jlay.block_n, block_t=s.block_t, interpret=True))
    want = packed[:, :nb].T if k is not None else packed[0, :nb]
    got = route_pack_ref(cell_lay, torch.from_numpy(port), num_cells=nb)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * np.abs(want).max())
    # padding positions carry the sentinel cell
    assert np.all(cell_lay.numpy()[tlay.coeff_lay.numpy() == 0] >= nb)


@pytest.mark.parametrize("k", [None, 1, 4])
def test_route_unpack_plain_matches_pallas(k):
    """B8's plain version against ``route_unpack_pallas`` in interpret
    mode: one product per position, so bitwise (sentinels read 0)."""
    jlay, tlay, jmaps, tmaps, _ = _setup()
    nb = 2 * tmaps[3]
    jplan = j_route_plan(jmaps[0], jlay, nb)
    cell_lay = D._make_route_plan(tmaps[0], tlay, nb)
    rng = np.random.default_rng(5)
    back = rng.standard_normal((nb,) if k is None else (nb, k)
                               ).astype(np.float32)
    s = jplan.sched
    cbbt = s.num_cell_tiles * s.block_t
    buf = np.pad(back, ((0, cbbt - nb),) + ((0, 0),) * (back.ndim - 1))
    buf = buf.T if k is not None else buf[None]
    out = np.asarray(route_unpack_pallas(
        s.u_block, s.u_tile, s.u_flag, jplan.cell_lay, jlay.coeff_lay,
        jnp.asarray(buf), block_n=jlay.block_n, block_t=s.block_t,
        interpret=True))
    if k is not None:
        out = out[:, None, :] if out.ndim == 2 else out
        out = np.swapaxes(out, 1, 2)                       # (m, L, k)
    got = route_unpack_ref(cell_lay, tlay.coeff_lay, torch.from_numpy(back))
    np.testing.assert_array_equal(got.numpy(), out)


@pytest.mark.parametrize("k", [None, 4])
def test_route_unpack_without_coeff_is_pallas_at_one(k):
    """B8's plain version with no coefficient (the sharded predict's
    unpack) against ``route_unpack_pallas`` in interpret mode with every
    coefficient 1: bitwise, sentinels reading 0."""
    jlay, tlay, jmaps, tmaps, _ = _setup()
    nb = 2 * tmaps[3]
    jplan = j_route_plan(jmaps[0], jlay, nb)
    cell_lay = D._make_route_plan(tmaps[0], tlay, nb)
    rng = np.random.default_rng(8)
    back = rng.standard_normal((nb,) if k is None else (nb, k)
                               ).astype(np.float32)
    s = jplan.sched
    cbbt = s.num_cell_tiles * s.block_t
    buf = np.pad(back, ((0, cbbt - nb),) + ((0, 0),) * (back.ndim - 1))
    buf = buf.T if k is not None else buf[None]
    out = np.asarray(route_unpack_pallas(
        s.u_block, s.u_tile, s.u_flag, jplan.cell_lay,
        jnp.ones_like(jlay.coeff_lay), jnp.asarray(buf),
        block_n=jlay.block_n, block_t=s.block_t, interpret=True))
    if k is not None:
        out = np.swapaxes(out, 1, 2)                       # (m, L, k)
    got = route_unpack_ref(cell_lay, None, torch.from_numpy(back))
    np.testing.assert_array_equal(got.numpy(), out)


def test_bf16_wire_cast_is_bitwise():
    """The wire cast rounds to nearest-even in both frameworks, ties,
    subnormals, infinities and NaN included."""
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    vals = bits.view(np.float32).copy()
    vals[:5] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1e-40, np.inf, -0.0]
    vals = vals[~np.isnan(vals)]
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(vals).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)
    # and the wire of a real pack: the port's f32 send cast both ways
    _, tlay, _, tmaps, _ = _setup()
    nb = 2 * tmaps[3]
    cell_lay = D._make_route_plan(tmaps[0], tlay, nb)
    port, _ = _contrib_layout(tlay, rng.standard_normal(200).astype(
        np.float32))
    send = route_pack_ref(cell_lay, torch.from_numpy(port), num_cells=nb)
    np.testing.assert_array_equal(
        send.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16),
        np.asarray(jnp.asarray(send.numpy()).astype(jnp.bfloat16)
                   ).view(np.uint16))


def test_query_shard_touch_matches_jax():
    from repro.core.distributed import query_shard_touch as jtouch
    slots = np.random.default_rng(7).integers(0, 1024, (50, 6))
    np.testing.assert_array_equal(D.query_shard_touch(slots, 1024, 4),
                                  jtouch(slots, 1024, 4))
    with pytest.raises(ValueError):
        D.query_shard_touch(slots, 1000, 3)


@pytest.mark.parametrize("cap_factor", [0.05, 0.3, 2.0])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_route_plan_order_that_b8_is_sized_on(n_shards, cap_factor):
    """The order B8's design counts on to be fast (never to be right):
    along every instance's real positions the cells do not decrease, each
    real cell is one contiguous run of the layout, and at most n_shards - 1
    steps exceed one (the owners' boundaries); in both packages' route
    plans, which are equal."""
    jlay, tlay, jmaps, tmaps, _ = _setup(m=4, n=1000, n_shards=n_shards,
                                         cap_factor=cap_factor)
    nb = n_shards * tmaps[3]
    port = D._make_route_plan(tmaps[0], tlay, nb).numpy()
    jax_plan = np.asarray(j_route_plan(jmaps[0], jlay, nb).cell_lay)
    np.testing.assert_array_equal(port, jax_plan)
    for plan in (port, jax_plan):
        seen = set()
        for row in plan:
            pos = np.nonzero(row < nb)[0]
            cells = row[pos]
            assert np.all(np.diff(cells) >= 0)
            assert np.count_nonzero(np.diff(cells) > 1) <= n_shards - 1
            same = cells[1:] == cells[:-1]
            # a run's positions are adjacent: no sentinel inside a run
            assert np.all(np.diff(pos)[same] == 1)
            heads = cells[np.r_[True, ~same]] if cells.size else cells
            assert not seen & set(heads.tolist())  # runs of one instance
            seen |= set(heads.tolist())
        assert np.all(plan[plan >= nb] == plan.max())   # one sentinel
    if cap_factor == 0.05:
        assert int(tmaps[4]) > 0       # buckets dropped onto the sentinel


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("coeff", [True, False])
@pytest.mark.parametrize("m", UNPACK_MS)
@pytest.mark.parametrize("k", UNPACK_KS)
@pytest.mark.parametrize("L", UNPACK_LS)
def test_route_unpack_plain_on_adversarial_cells(L, k, m, coeff, offset):
    """B8's plain version bitwise against a numpy oracle on cells that
    break the routing's order: random, negative, descending, sentinels at
    num_cells and 2^31 - 1, signed zeros, rows one element off 16-byte
    alignment (the inputs the card test and chip_smoke.py phase 5 give the
    kernel)."""
    cell, cf, back = unpack_case(100 + L + k, m, L, k, coeff=coeff,
                                 offset=offset)
    got = route_unpack_ref(cell, cf, back)
    want = unpack_oracle(cell.numpy(), None if cf is None else cf.numpy(),
                         back.numpy())
    assert got.shape == want.shape
    np.testing.assert_array_equal(unpack_bits(got), want.view(np.uint32))
