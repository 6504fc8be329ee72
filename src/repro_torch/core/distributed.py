"""Distributed WLSH-KRR on a ``torch.distributed`` (data, model) grid.

The JAX package's data-parallel step (``repro.core.distributed``), with each
rank running one shard of its ``shard_map`` body:

* **points** are split over the data ranks; **instances** (the m WLSH
  estimators) over the model ranks (``launch/mesh.py``).
* **psum table mode** (``make_krr_step``): each data rank scatters its
  points' loads into local (m_loc, B[, k]) tables, one ``all_reduce`` over
  the data group merges them, every rank reads its own points back, and an
  ``all_reduce`` over the model group completes the instance sum.  With one
  data rank and ``fused`` the one-pass matvec runs instead.
* **hash-join table mode** (``make_krr_step_hashjoin``): the table is split
  over the data ranks (rank r owns slots [r*spp, (r+1)*spp)), and only the
  distinct (instance, slot) cells travel: pack -> ``all_to_all_single`` ->
  serve -> ``all_to_all_single`` -> unpack, with a bf16 or f32 wire.
* **CG** runs on the sharded vectors; its dots are ``all_reduce``s of a
  scalar (or (k,)) tensor.  The loop has no host sync: dead-column flags
  stay on the device.

Every collective runs whatever the group's size: a group of one rank runs
the same code path as a multi-card job.  The step functions take this
rank's shards (x, y by rows over data; LSH rows over model) and return this
rank's shards of the results.
"""
from __future__ import annotations

import logging
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..backend import as_tensor
from ..errors import SolveDivergedError, WireOverflowError
from ..kernels.binning.ops import (layout_rows, route_pack_op,
                                   route_unpack_op, rows_to_points)
from ..launch.mesh import Mesh
from ..testing.faults import FaultPlan, apply_wire_fault, maybe_stall
from .bucket_fns import BucketFn
from .lsh import LSHParams
from .operator import WLSHOperator
from .precond import (DEFAULT_NYSTROM_RANK, PRECOND_NAMES, jacobi_precond,
                      nystrom_precond, table_diag)

_LOG = logging.getLogger("repro_torch.distributed")


class KRRStepConfig(NamedTuple):
    m: int                 # total WLSH instances (split over model ranks)
    table_size: int        # CountSketch table slots (power of two)
    lam: float             # ridge regularizer
    cg_iters: int          # fixed PCG iteration count of the step
    fused: bool = True     # one-pass local matvec when there is one data rank
    blocked_split: bool = True  # split loads/readout off the slot-blocked
                                # layout (B3, B6); else the point kernels
                                # (B5, B4)
    precond: str = "none"  # 'none' | 'jacobi' (any grid) | 'nystrom'
                           # (one data rank only)
    precond_rank: int = DEFAULT_NYSTROM_RANK
    overflow: str = "warn"  # hash-join capacity-overflow policy, enforced by
                            # check_step_stats: 'raise' | 'warn' | 'allow'
    fault_plan: FaultPlan | None = None  # test-only fault injection


class _PhaseClock:
    """Phase boundaries of one step call, as CUDA events on the card (no
    host sync while the step runs) or host times on the CPU; ``ms()``
    reads the split of the last call, in milliseconds."""

    def __init__(self):
        self._marks = []

    def start(self, device: torch.device) -> None:
        self._cuda = device.type == "cuda"
        self._marks = []
        self.mark("")

    def mark(self, name: str) -> None:
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self._marks.append((name, ev))

    def ms(self) -> dict[str, float]:
        if not self._marks:
            return {}
        if self._cuda:
            self._marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self._marks, self._marks[1:]):
            out[name] = a.elapsed_time(b) if self._cuda else (b - a) * 1e3
        return out


def _shard_inputs(mesh: Mesh, x, y, lsh: LSHParams):
    dev = mesh.device
    return (as_tensor(x, dev), None if y is None else as_tensor(y, dev),
            lsh.to(dev))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` with equal splits on dim 0 (JAX's tiled
    all_to_all over the data axis)."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def make_distributed_matvec(cfg: KRRStepConfig, op: WLSHOperator, *,
                            mesh: Mesh):
    """matvec(index, beta_local) -> (K~ beta)_local for an index of this
    rank's points and instances and a (n_loc,) or (n_loc, k) beta shard.

    With several data ranks the tables must exist between the scatter and
    the gather (their ``all_reduce`` is the barrier), so the split
    loads -> all_reduce -> readout runs; with one data rank and
    ``cfg.fused`` the one-pass matvec runs and only the model reduce
    remains."""
    local_fused = cfg.fused and mesh.data == 1

    def matvec(index, beta_local):
        if local_fused and index.blocked is not None:
            out = op.matvec(index, beta_local, average=False)
        else:
            tables = _all_reduce(op.loads(index, beta_local),
                                 mesh.data_group)
            out = op.readout(index, tables, average=False)
        return _all_reduce(out, mesh.model_group) / cfg.m
    return matvec


def _bcast(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-column coefficient times v (n,) or (n, k)."""
    return c * v if v.ndim == 1 else c[None, :] * v


def _colmask(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return c if v.ndim == 1 else c[None, :]


def cg_iterations(matvec, y_local: torch.Tensor, cfg: KRRStepConfig,
                  mesh: Mesh, precond_apply=None):
    """Fixed-iteration PCG on (K~ + lam I) beta = y with data-sharded
    vectors (the JAX package's ``cg_iterations``, line by line).  Returns
    (beta_local, resnorm), resnorm per column for a block.

    A non-finite step deactivates its column before the bad update lands:
    (x, r) freeze at the last finite iterate and the column's resnorm is
    NaN.  The loop reads nothing back to the host: every flag is a device
    tensor combined with ``torch.where``."""
    lam = float(cfg.lam)
    identity = precond_apply is None
    psolve = (lambda r: r) if identity else precond_apply

    def amv(v):
        return matvec(v) + lam * v

    def dot(a, b):
        return _all_reduce((a * b).sum(0), mesh.data_group)

    def residual_dots(r, z):
        rs = dot(r, r)
        return (rs, rs) if identity else (dot(r, z), rs)

    x = torch.zeros_like(y_local)
    r = y_local - amv(x)
    z = psolve(r)
    rho, rs = residual_dots(r, z)
    dead = ~(torch.isfinite(rho) & torch.isfinite(rs))
    p = torch.where(_colmask(~dead, z), z, 0.0)
    for _ in range(cfg.cg_iters):
        ap = amv(p)
        alpha = rho / dot(p, ap).clamp(min=1e-30)
        ok = torch.isfinite(alpha) & ~dead
        dead = dead | ~torch.isfinite(alpha)
        okb = _colmask(ok, p)
        alpha = torch.where(ok, alpha, 0.0)
        x = x + torch.where(okb, _bcast(alpha, p), 0.0)
        r = r - torch.where(okb, _bcast(alpha, ap), 0.0)
        z = psolve(r)
        rho_new, rs_new = residual_dots(r, z)
        dead = dead | ~(torch.isfinite(rho_new) & torch.isfinite(rs_new))
        live = ~dead
        beta = torch.where(live, rho_new / rho.clamp(min=1e-30), 0.0)
        p = torch.where(_colmask(live, p), z + _bcast(beta, p), 0.0)
        rho = torch.where(live, rho_new, rho)
        rs = torch.where(live, rs_new, rs)
    return x, torch.where(dead, float("nan"), torch.sqrt(rs))


def _shard_preconditioner(cfg: KRRStepConfig, mesh: Mesh, mv, idx):
    """cfg.precond's apply on local shards, or None.  jacobi: the diagonal
    mean_s coeff^2 is per point, so it needs only the model reduce.
    nystrom: pivot columns are global K~ matvecs, which the local index
    gives only with one data rank (``mv`` may be None when the caller has
    rejected nystrom already)."""
    if cfg.precond in ("none", None):
        return None
    diag = _all_reduce(table_diag(idx.coeff, average=False),
                       mesh.model_group) / cfg.m
    if cfg.precond == "jacobi":
        return jacobi_precond(diag, cfg.lam).apply
    if cfg.precond == "nystrom":
        return nystrom_precond(lambda v: mv(idx, v), diag, cfg.lam,
                               cfg.precond_rank).apply
    raise ValueError(f"unknown preconditioner {cfg.precond!r}; "
                     f"expected one of {PRECOND_NAMES}")


def make_krr_step(mesh: Mesh, cfg: KRRStepConfig, f: BucketFn):
    """The psum-mode training step of this rank.

    step(x_local, y_local, lsh_local) -> (beta_local, resnorm, tables)
      x_local (n_loc, d) and y_local (n_loc,) or (n_loc, k): my data shard;
      lsh_local: my model shard of the instances (m_loc rows).
    beta_local is my shard of beta; resnorm is the same on every rank;
    tables (m_loc, B[, k]) are my instances' prediction tables (the same
    on every data rank).  ``step.phase_ms()`` gives the last call's split
    (featurize, layout, cg, tables).

    ``cfg.precond='nystrom'`` needs one data rank and raises otherwise."""
    local_fused = cfg.fused and mesh.data == 1
    want_blocked = local_fused or cfg.blocked_split
    if cfg.precond == "nystrom" and mesh.data != 1:
        raise ValueError(
            "precond='nystrom' needs unsharded data (its pivot columns are "
            "global K~ matvecs); use 'jacobi' with several data ranks")
    clock = _PhaseClock()

    def step(x_local, y_local, lsh_local):
        x, y, lsh = _shard_inputs(mesh, x_local, y_local, lsh_local)
        clock.start(mesh.device)
        op = WLSHOperator(lsh=lsh, bucket=f, table_size=cfg.table_size,
                          fused=local_fused)
        feats = op.featurize(x)
        clock.mark("featurize")
        idx = op.build_index(feats, blocked=want_blocked)
        del feats
        clock.mark("layout")
        mv = make_distributed_matvec(cfg, op, mesh=mesh)
        pre = _shard_preconditioner(cfg, mesh, mv, idx)
        beta, resnorm = cg_iterations(lambda v: mv(idx, v), y, cfg, mesh,
                                      precond_apply=pre)
        clock.mark("cg")
        tables = _all_reduce(op.loads(idx, beta), mesh.data_group)
        clock.mark("tables")
        return beta, resnorm, tables

    step.phase_ms = clock.ms
    return step


def make_krr_predict(mesh: Mesh, cfg: KRRStepConfig, f: BucketFn):
    """predict(x_local, lsh_local, tables_local) -> my shard of yhat.

    The query index takes the training step's layout choice, so the
    readout gathers over the slot-blocked layout (B6) when the step's
    tables came off it; with ``blocked_split`` off and several data ranks
    it gathers per point (B4)."""
    local_fused = cfg.fused and mesh.data == 1
    want_blocked = local_fused or cfg.blocked_split

    def predict(x_local, lsh_local, tables_local):
        x, _, lsh = _shard_inputs(mesh, x_local, None, lsh_local)
        op = WLSHOperator(lsh=lsh, bucket=f, table_size=cfg.table_size,
                          fused=local_fused)
        idx = op.build_index(op.featurize(x), blocked=want_blocked)
        out = op.readout(idx, tables_local, average=False)
        return _all_reduce(out, mesh.model_group) / cfg.m

    return predict


# ---------------------------------------------------------------------------
# hash-join table mode
# ---------------------------------------------------------------------------
#
# The psum moves the whole (m_loc, B) table per CG iteration although each
# rank touches only O(n_loc) cells.  The hash join splits the TABLE over
# the data ranks and routes only the distinct (instance, slot) cells: a
# point's bucket is cell owner*cap + off[inst, owner] + rank on the wire to
# its owner, derived from the layout's stable slot sort (no second sort).
# Per iteration: route pack (B7) -> all_to_all -> serve (sum over sender
# runs through a precomputed map) -> all_to_all -> route unpack (B8) ->
# model reduce.  Buckets past a destination's capacity are dropped and
# counted (StepStats).

# the JAX package's route-kernel cell tile; its multiple is the sentinel
# cell of dropped and padding layout positions
ROUTE_BLOCK_T = 512


class _Routing(NamedTuple):
    cell_lay: torch.Tensor   # (m_loc, L) int32 wire cell per layout
                             #   position (sentinel >= n_shards*cap)
    recv_ids: torch.Tensor   # (NB,) int32 owner-side table id per received
                             #   cell (sentinel m_loc*spp = empty cell)
    serve_map: torch.Tensor  # (n_shards, NB) int32 flat recv position of
                             #   each cell's table id in sender run r
                             #   (sentinel NB = absent)
    spp: int                 # slots per data rank
    cap: int                 # cells per destination rank
    dropped: torch.Tensor    # () int32 distinct buckets past capacity here
    used: torch.Tensor       # (n_shards,) int32 cells bound for owner o:
                             #   the dense range [o*cap, o*cap + used[o])


def _routing_maps(slot: torch.Tensor, lay, n_shards: int, table_size: int,
                  cap_factor: float):
    """Pure half of the routing build (no collectives, no sort), bitwise
    as the JAX package's: (pt_cell, send_packed, spp, cap, dropped,
    owner_max), and the port's ``used`` (n_shards,) int32: the distinct
    buckets bound for each owner, clamped to cap, so owner o's real cells
    are exactly [o*cap, o*cap + used[o]).  Owners ascend with the layout's
    sorted slots, so group starts come from ``searchsorted`` and in-group
    ranks from the layout's segment ids."""
    m_loc, n_loc = slot.shape
    dev, i32 = slot.device, torch.int32
    e = m_loc * n_loc
    spp = table_size // n_shards
    cap = max(8, int(-(-e * cap_factor // n_shards) // 8 * 8))
    # a cell is a distinct (instance, slot) pair at its owner: never more
    # than the owner's m_loc*spp table cells (exact => dedup cannot drop)
    cap = min(cap, m_loc * spp)
    nb = n_shards * cap

    inst = torch.arange(m_loc, dtype=i32, device=dev)[:, None]
    ss = slot.gather(1, lay.perm.long())                      # sorted slots
    owner = ss // spp                                         # ascending rows
    owner_l = owner.long()
    is_first = torch.ones_like(ss, dtype=torch.bool)
    is_first[:, 1:] = ss[:, 1:] != ss[:, :-1]
    # distinct buckets per (instance, owner) and their cross-instance offsets
    ucount = torch.zeros((m_loc, n_shards), dtype=i32, device=dev)
    ucount.scatter_add_(1, owner_l, is_first.to(i32))
    off = torch.cumsum(ucount, 0, dtype=i32) - ucount         # exclusive
    fpos = torch.searchsorted(
        owner, torch.arange(n_shards, dtype=i32, device=dev).expand(
            m_loc, n_shards).contiguous(), out_int32=True)
    fpos = fpos.clamp(max=n_loc - 1)
    first_seg = lay.seg_id.gather(1, fpos.long())             # (m, S)
    rank = lay.seg_id - first_seg.gather(1, owner_l)
    pos = off.gather(1, owner_l) + rank
    del owner_l, first_seg, rank, fpos
    keep = is_first & (pos < cap)
    dropped = (is_first & (pos >= cap)).sum(dtype=i32)
    per_owner = ucount.sum(0, dtype=i32)
    owner_max = per_owner.max()
    used = per_owner.clamp(max=cap)
    cell = owner * cap + pos                                  # where keep
    del pos, owner
    flat_seg = inst * n_loc + lay.seg_id                      # (m, n)
    useg_cell = torch.full((e,), nb, dtype=i32, device=dev)
    useg_cell[flat_seg[keep]] = cell[keep]
    del flat_seg
    # each bucket's cell broadcast back to its points
    pt_cell = useg_cell[inst * n_loc + lay.seg_pt]            # (m, n)
    del useg_cell
    packed = inst * spp + ss % spp
    send_packed = torch.full((nb,), -1, dtype=i32, device=dev)
    send_packed[cell[keep]] = packed[keep]
    return (pt_cell, send_packed.view(n_shards, cap), spp, cap, dropped,
            owner_max, used)


def _log_routing_build(owner_max: int, *, cap: int, n_shards: int) -> None:
    over = owner_max > cap
    _LOG.log(logging.WARNING if over else logging.INFO,
             "hashjoin routing: max %d cells/owner vs capacity %d "
             "(%d shard(s))%s", owner_max, cap, n_shards,
             " — OVERFLOW, distinct buckets will be dropped" if over else "")
    obs.counter("hashjoin_routing_builds_total",
                "hash-join routing tables built").inc()
    obs.gauge("hashjoin_route_cap",
              "per-owner cell capacity of the last routing build").set(cap)
    obs.gauge("hashjoin_route_owner_max",
              "max observed cells/owner in the last routing build"
              ).set(owner_max)


def _make_route_plan(pt_cell: torch.Tensor, lay, nb: int) -> torch.Tensor:
    """The per-point wire cells laid out along the slot-blocked layout:
    ``cell_lay`` (m, L), bitwise as the JAX package's route plan, with
    dropped points and padding positions on the sentinel cell.  Cells
    ascend along each instance's layout (owner, then in-owner rank)."""
    m_loc, n_loc = pt_cell.shape
    sentinel = -(-nb // ROUTE_BLOCK_T) * ROUTE_BLOCK_T
    rows = torch.arange(m_loc, dtype=torch.int32, device=pt_cell.device)
    ptc_pad = torch.cat([pt_cell, torch.full((m_loc, 1), nb,
                                             dtype=torch.int32,
                                             device=pt_cell.device)], 1)
    flat = lay.src + (rows * (n_loc + 1))[:, None]
    cell_lay = ptc_pad.view(-1)[flat]
    return torch.where(cell_lay < nb, cell_lay, sentinel)


def _build_routing(slot: torch.Tensor, lay, mesh: Mesh, table_size: int,
                   cap_factor: float) -> _Routing:
    """The point <-> wire-cell maps and the exchanged slot requests, once
    per solve (slots are fixed).  The max cells per owner is read back to
    the host once and logged: the headroom signal for ``cap_factor``."""
    n_shards = mesh.data
    pt_cell, send_packed, spp, cap, dropped, owner_max, used = _routing_maps(
        slot, lay, n_shards, table_size, cap_factor)
    _log_routing_build(int(owner_max), cap=cap, n_shards=n_shards)
    cell_lay = _make_route_plan(pt_cell, lay, n_shards * cap)
    del pt_cell
    recv_packed = _a2a(send_packed, mesh.data_group).view(-1)
    m_loc = slot.shape[0]
    recv_ids = torch.where(recv_packed >= 0, recv_packed, m_loc * spp)
    del recv_packed, send_packed
    # each sender run of recv_ids is sorted (instance-major, slot-ascending;
    # sentinels trail), so a table id's position in run r is one
    # searchsorted: the per-iteration serve is n_shards gathers
    nb = n_shards * cap
    pos = torch.searchsorted(recv_ids.view(n_shards, cap),
                             recv_ids.expand(n_shards, nb).contiguous(),
                             out_int32=True).clamp(max=cap - 1)
    cand = pos + (torch.arange(n_shards, dtype=torch.int32,
                               device=slot.device) * cap)[:, None]
    del pos
    hit = (recv_ids[cand] == recv_ids[None]) & (recv_ids < m_loc * spp)[None]
    serve_map = torch.where(hit, cand, nb)
    return _Routing(cell_lay=cell_lay, recv_ids=recv_ids,
                    serve_map=serve_map, spp=spp, cap=cap, dropped=dropped,
                    used=used)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] where an index past the end (the sentinel len(src)) reads
    0 (JAX's ``.at[idx].get(mode='fill', fill_value=0)``), without copying
    src behind a zero row."""
    ok = idx < src.shape[0]
    vals = src[torch.where(ok, idx, 0)]
    return torch.where(ok if src.ndim == 1 else ok[..., None], vals, 0.0)


def _hashjoin_send(rt: _Routing, lay, beta_local: torch.Tensor,
                   payload_dtype, plan: FaultPlan | None = None):
    """Route pack (B7): per-point contributions -> (n_shards, cap[, k])
    wire payload in one pass: each distinct bucket summed in f32 and
    rounded once to the wire dtype by the pack itself, each owner's
    unreached tail written as zeros.  ``plan`` (tests) drops or poisons
    cells after the pack."""
    tail = tuple(beta_local.shape[1:])
    beta_lay = layout_rows(lay, beta_local)                  # (m, L[, k])
    coeff = lay.coeff_lay if not tail else lay.coeff_lay[..., None]
    send = route_pack_op(rt.cell_lay, coeff * beta_lay, rt.used, rt.cap,
                         out_dtype=payload_dtype)
    wire = send.view((rt.used.shape[0], rt.cap) + tail)
    return apply_wire_fault(plan, wire)


def _hashjoin_loads(rt: _Routing, lay, beta_local: torch.Tensor,
                    mesh: Mesh, m_loc: int, payload_dtype,
                    plan: FaultPlan | None = None):
    """Pack + all_to_all + owner scatter-add: MY (m_loc*spp[, k]) f32 table
    shard and the count of non-finite received cells, which are zeroed
    before they can poison a table slot.  Empty cells are dropped before
    the scatter-add (one host sync per solve): sent to one spare row, the
    few hundred million of a one-rank buffer would all add to one
    address."""
    tail = tuple(beta_local.shape[1:])
    nb = rt.recv_ids.shape[0]
    send = _hashjoin_send(rt, lay, beta_local, payload_dtype, plan)
    recv = _a2a(send, mesh.data_group).view((nb,) + tail).float()
    finite = torch.isfinite(recv)
    nonfinite = (~finite).sum(dtype=torch.int32)
    recv = torch.where(finite, recv, 0.0)
    size = m_loc * rt.spp
    live = (rt.recv_ids < size).nonzero()[:, 0]
    table = torch.zeros((size,) + tail, dtype=torch.float32,
                        device=recv.device)
    table.index_add_(0, rt.recv_ids[live], recv[live])
    return table, nonfinite


def _hashjoin_return(rt: _Routing, lay, served: torch.Tensor, mesh: Mesh,
                     m_total: int, payload_dtype,
                     plan: FaultPlan | None = None, sanitize: bool = False):
    """all_to_all the served (NB[, k]) values back and unpack (B8):
    out = reduce_model(sum_s coeff * back[cell]) / m.  ``sanitize`` zeroes
    non-finite received cells (prediction: a fault degrades to dropped
    mass); the CG matvec leaves them in, for the solver's sentinel."""
    tail = tuple(served.shape[1:])
    nb = rt.recv_ids.shape[0]
    n_shards = nb // rt.cap
    wire = apply_wire_fault(
        plan, served.to(payload_dtype).view((n_shards, rt.cap) + tail))
    back = _a2a(wire, mesh.data_group).view((nb,) + tail).float()
    if sanitize:
        back = torch.where(torch.isfinite(back), back, 0.0)
    out_lay = route_unpack_op(rt.cell_lay, lay.coeff_lay, back)
    out = rows_to_points(lay, out_lay).sum(0)
    return _all_reduce(out, mesh.model_group) / m_total


def _hashjoin_readout(rt: _Routing, lay, table_flat: torch.Tensor,
                      mesh: Mesh, m_total: int, payload_dtype,
                      plan: FaultPlan | None = None):
    """Serve the fixed slot requests from my table shard and return them
    (prediction against a stored shard)."""
    served = _take(table_flat, rt.recv_ids)
    return _hashjoin_return(rt, lay, served, mesh, m_total, payload_dtype,
                            plan, sanitize=True)


def _hashjoin_matvec(rt: _Routing, lay, m_total: int, mesh: Mesh,
                     beta_local: torch.Tensor, payload_dtype,
                     plan: FaultPlan | None = None):
    """One hash-join K~ matvec: pack -> all_to_all -> serve -> all_to_all
    -> unpack -> model reduce.  The serve never builds the owner's table:
    each cell's sum over the sender runs is read through ``serve_map``."""
    tail = tuple(beta_local.shape[1:])
    nb = rt.recv_ids.shape[0]
    send = _hashjoin_send(rt, lay, beta_local, payload_dtype, plan)
    recv = _a2a(send, mesh.data_group).view((nb,) + tail).float()
    served = _take(recv, rt.serve_map[0])
    for r in range(1, rt.serve_map.shape[0]):
        served = served + _take(recv, rt.serve_map[r])
    return _hashjoin_return(rt, lay, served, mesh, m_total, payload_dtype)


class StepStats(NamedTuple):
    """Fault counters of one hash-join step, reduced over every rank."""

    overflow_dropped: torch.Tensor   # distinct buckets dropped past capacity
    wire_nonfinite: torch.Tensor     # non-finite wire cells zeroed in the
                                     # final (f32) table exchange


OVERFLOW_POLICIES = ("raise", "warn", "allow")


def check_step_stats(stats: StepStats, *, overflow: str = "warn") -> None:
    """Host-side policy gate for a finished hash-join step: 'raise' turns
    dropped buckets or zeroed non-finite wire cells into a
    ``WireOverflowError``, 'warn' warns, 'allow' lets them pass (they are
    counted either way)."""
    if overflow not in OVERFLOW_POLICIES:
        raise ValueError(f"overflow must be one of {OVERFLOW_POLICIES}, "
                         f"got {overflow!r}")
    dropped = int(stats.overflow_dropped)
    nonfinite = int(stats.wire_nonfinite)
    obs.counter("hashjoin_steps_checked_total",
                "hash-join steps run through the fault-policy gate").inc()
    if dropped:
        obs.counter("hashjoin_overflow_dropped_total",
                    "distinct buckets dropped past routing capacity"
                    ).inc(dropped)
    if nonfinite:
        obs.counter("hashjoin_wire_nonfinite_total",
                    "non-finite wire cells zeroed in table exchanges"
                    ).inc(nonfinite)
    if dropped == 0 and nonfinite == 0:
        return
    msg = (f"hashjoin step dropped {dropped} distinct bucket(s) past the "
           f"routing capacity and zeroed {nonfinite} non-finite wire "
           f"cell(s); raise cap_factor or investigate the payload")
    if overflow == "raise":
        raise WireOverflowError(msg, dropped=dropped)
    if overflow == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=2)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_krr_step_resilient(mesh: Mesh, cfg: KRRStepConfig, f: BucketFn,
                           x, y, lsh, *, cap_factor: float = 2.0,
                           payload_dtype=torch.bfloat16):
    """The hash-join step with the recovery ladder: run on the configured
    wire, apply ``cfg.overflow`` to the step's counters, retry a non-finite
    solve once on an f32 wire (bf16 only), and raise
    ``SolveDivergedError`` if it is still non-finite.  Returns (beta,
    resnorm, table, stats) as ``make_krr_step_hashjoin``.  Host-side: the
    policy check reads the counters back.  resnorm and the counters are
    the same on every rank, so every rank takes the same branch."""
    step = make_krr_step_hashjoin(mesh, cfg, f, cap_factor=cap_factor,
                                  payload_dtype=payload_dtype)
    wire = str(payload_dtype).replace("torch.", "")
    with obs.span("dist.krr_step", {"wire": wire},
                  to_histogram=obs.histogram(
                      "dist_krr_step_us",
                      "resilient hash-join step wall time")):
        beta, resnorm, table, stats = step(x, y, lsh)
        _sync(resnorm)
    check_step_stats(stats, overflow=cfg.overflow)
    retried = False
    if not bool(torch.isfinite(resnorm).all()):
        if payload_dtype == torch.bfloat16:
            warnings.warn("non-finite CG residual on the bf16 wire; "
                          "retrying once with an f32 wire",
                          RuntimeWarning, stacklevel=2)
            obs.counter("dist_wire_retry_total",
                        "bf16 wire solves retried on an f32 wire").inc()
            retried = True
            step32 = make_krr_step_hashjoin(mesh, cfg, f,
                                            cap_factor=cap_factor,
                                            payload_dtype=torch.float32)
            with obs.span("dist.krr_step", {"wire": "float32"}):
                beta, resnorm, table, stats = step32(x, y, lsh)
                _sync(resnorm)
            check_step_stats(stats, overflow=cfg.overflow)
        if not bool(torch.isfinite(resnorm).all()):
            obs.counter("dist_solve_diverged_total",
                        "distributed solves abandoned after all retries"
                        ).inc()
            raise SolveDivergedError(
                "distributed CG residual non-finite"
                + (" (f32 wire retry included)" if retried else ""),
                resnorm=resnorm.cpu().numpy(),
                fallbacks=("wire:bf16->f32",) if retried else ())
    return beta, resnorm, table, stats


def make_krr_step_hashjoin(mesh: Mesh, cfg: KRRStepConfig, f: BucketFn, *,
                           cap_factor: float = 2.0,
                           payload_dtype=torch.bfloat16):
    """The hash-join training step of this rank:
    step(x_local, y_local, lsh_local) -> (beta_local, resnorm, table,
    stats), as ``make_krr_step`` but with the table SPLIT over the data
    ranks: ``table`` (m_loc, spp[, k]) holds slots [r*spp, (r+1)*spp) of my
    instances on data rank r, the piece ``make_krr_predict_hashjoin``
    reads.  ``stats`` is a ``StepStats``; feed it to ``check_step_stats``
    (or use ``run_krr_step_resilient``) to enforce ``cfg.overflow``.

    The CG wire is ``payload_dtype`` (bf16 halves its bytes; f32 gives the
    psum mode's result); the final table exchange is always f32.  jacobi
    is supported; nystrom raises (its pivot columns need global matvecs).
    ``step.phase_ms()`` gives the last call's split (featurize, layout,
    routing, cg, tables)."""
    if cfg.precond == "nystrom":
        raise ValueError(
            "precond='nystrom' needs global matvecs for its pivot columns; "
            "the hash-join step supports 'jacobi' (shard-local apply)")
    if cfg.precond not in ("none", None, "jacobi"):
        raise ValueError(f"unknown preconditioner {cfg.precond!r}; "
                         f"expected one of {PRECOND_NAMES}")
    n_shards = mesh.data
    if cfg.table_size % n_shards:
        raise ValueError("hash-join needs table_size divisible by the data "
                         f"shard count ({cfg.table_size} % {n_shards})")
    clock = _PhaseClock()

    def step(x_local, y_local, lsh_local):
        maybe_stall(cfg.fault_plan, mesh.data_rank)
        x, y, lsh = _shard_inputs(mesh, x_local, y_local, lsh_local)
        clock.start(mesh.device)
        op = WLSHOperator(lsh=lsh, bucket=f, table_size=cfg.table_size,
                          fused=False)
        feats = op.featurize(x)
        clock.mark("featurize")
        # the layout's stable slot sort is the only sort of the step
        idx = op.build_index(feats, blocked=True, parts="both")
        del feats
        clock.mark("layout")
        m_loc = idx.slot.shape[0]
        rt = _build_routing(idx.slot, idx.blocked, mesh, cfg.table_size,
                            cap_factor)
        # the routing consumed the layout's sorted-segment group
        lay = idx.blocked._replace(perm=None, seg_id=None, seg_pt=None,
                                   coeff_sorted=None)
        idx = idx._replace(blocked=None, slot=None, sign=None, weight=None)
        clock.mark("routing")
        k_cols = 1 if y.ndim == 1 else y.shape[1]
        obs.gauge(
            "hashjoin_a2a_payload_bytes",
            "per-rank all_to_all payload bytes per CG iteration "
            "(route + serve exchanges)").set(
            2 * n_shards * rt.cap * k_cols
            * torch.empty((), dtype=payload_dtype).element_size())
        mv = lambda v: _hashjoin_matvec(rt, lay, cfg.m, mesh, v,
                                        payload_dtype, cfg.fault_plan)
        pre = _shard_preconditioner(cfg, mesh, None, idx)
        beta, resnorm = cg_iterations(mv, y, cfg, mesh, precond_apply=pre)
        clock.mark("cg")
        table, wire_nf = _hashjoin_loads(rt, lay, beta, mesh, m_loc,
                                         torch.float32, cfg.fault_plan)
        stats = StepStats(
            overflow_dropped=_all_reduce(rt.dropped.clone(), None),
            wire_nonfinite=_all_reduce(wire_nf, None))
        clock.mark("tables")
        return beta, resnorm, table.view((m_loc, rt.spp) + table.shape[1:]), \
            stats

    step.phase_ms = clock.ms
    return step


def _broadcast_readout(slot: torch.Tensor, coeff: torch.Tensor,
                       table_flat: torch.Tensor, mesh: Mesh, spp: int,
                       m_total: int, payload_dtype) -> torch.Tensor:
    """Route -> serve -> readout WITHOUT the dedup pack: every owner gets
    the raw (m_loc, n_loc) slot requests (one int32 all_to_all), serves
    the ones it owns (others read 0: each request has one owner), and the
    value exchange sums over the owners.  No layout, no capacity, nothing
    to overflow; the wire is O(n_shards * m_loc * n_loc)."""
    m_loc, n_loc = slot.shape
    n_shards = mesh.data
    send = slot[None].expand(n_shards, m_loc, n_loc)
    recv = _a2a(send, mesh.data_group)
    local = recv - dist.get_rank(mesh.data_group) * spp
    inst = torch.arange(m_loc, dtype=torch.int32, device=slot.device)
    ids = torch.where((local >= 0) & (local < spp),
                      inst[None, :, None] * spp + local, m_loc * spp)
    served = _take(table_flat, ids)
    back = _a2a(served.to(payload_dtype), mesh.data_group).float()
    back = torch.where(torch.isfinite(back), back, 0.0)
    vals = back.sum(0)                               # (m_loc, n_loc[, k])
    contrib = coeff * vals if vals.ndim == 2 else coeff[..., None] * vals
    return _all_reduce(contrib.sum(0), mesh.model_group) / m_total


def make_krr_predict_hashjoin(mesh: Mesh, cfg: KRRStepConfig, f: BucketFn,
                              *, cap_factor: float = 2.0,
                              payload_dtype=torch.bfloat16,
                              with_stats: bool = False,
                              dedup: bool = True):
    """predict(x_local, lsh_local, table_local) -> my shard of yhat,
    against the table piece ``make_krr_step_hashjoin`` left on this rank.

    ``dedup=True`` (bulk scoring) routes the deduplicated (instance, slot)
    cells through the training routing (minimal wire bytes);
    ``dedup=False`` (interactive serving) routes the raw requests (no
    layout, no routing build, no capacity).  ``with_stats`` also returns
    a (1,) int32 tensor: distinct buckets dropped past capacity by this
    data rank, summed over the model ranks (always 0 without dedup)."""
    n_shards = mesh.data
    if cfg.table_size % n_shards:
        raise ValueError("hash-join needs table_size divisible by the data "
                         f"shard count ({cfg.table_size} % {n_shards})")

    def predict(x_local, lsh_local, table_local):
        x, _, lsh = _shard_inputs(mesh, x_local, None, lsh_local)
        op = WLSHOperator(lsh=lsh, bucket=f, table_size=cfg.table_size,
                          fused=False)
        table_flat = table_local.reshape((-1,) + tuple(table_local.shape[2:]))
        if not dedup:
            idx = op.build_index(op.featurize(x), blocked=False)
            out = _broadcast_readout(idx.slot, idx.coeff, table_flat, mesh,
                                     cfg.table_size // n_shards, cfg.m,
                                     payload_dtype)
            if with_stats:
                return out, torch.zeros((1,), dtype=torch.int32,
                                        device=out.device)
            return out
        idx = op.build_index(op.featurize(x), blocked=True, parts="both")
        rt = _build_routing(idx.slot, idx.blocked, mesh, cfg.table_size,
                            cap_factor)
        out = _hashjoin_readout(rt, idx.blocked, table_flat, mesh, cfg.m,
                                payload_dtype, cfg.fault_plan)
        if with_stats:
            return out, _all_reduce(rt.dropped.clone(),
                                    mesh.model_group)[None]
        return out

    return predict


def query_shard_touch(slots, table_size: int, n_shards: int):
    """(n, m) per-query table slots -> (n, n_shards) bool touch masks: data
    rank j owns slots [j*spp, (j+1)*spp), so a query's prediction depends
    only on the ranks its m slots land on.  Pure numpy."""
    slots = np.asarray(slots)
    if table_size % n_shards:
        raise ValueError(f"table_size={table_size} not divisible by "
                         f"n_shards={n_shards}")
    owners = slots // (table_size // n_shards)
    touch = np.zeros((slots.shape[0], n_shards), bool)
    touch[np.arange(slots.shape[0])[:, None], owners] = True
    return touch
