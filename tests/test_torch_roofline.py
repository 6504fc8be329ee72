"""The port's roofline tracer (``repro_torch.roofline``) on the CPU: the
counterparts of ``tests/test_hlo_analysis.py`` (dot FLOPs, the trip-count
scaling, the roofline terms, a smoke analysis), the trace queries on the
port's own programs (one sort a hash-join step, no (m, B) table in the
fused matvec), the kernels' meta twins, rwkv6's scaled recurrence (its
counts and its peak), and the traced matmul FLOPs of the smoke prefill and
train steps against the JAX package's ``hlo_analysis`` of its own compiled
steps.

FLOP counts are sums of exact products of shapes, held exactly; where a
comparison is not exact its docstring says why and by how much."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as JR
from repro.configs.base import ShapeSpec as JShape
from repro.hlo_analysis import analyze_hlo_text
from repro.launch import specs as JSP
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch import core as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.wlsh_krr import CONFIG as KRR
from repro_torch.core import distributed as D
from repro_torch.core.lsh import LSHParams
from repro_torch.core.operator import WLSHOperator
from repro_torch.kernels.binning import ops as BO
from repro_torch.kernels.featurize.ops import featurize_op
from repro_torch.kernels.flash_decode.ops import decode_attend_op
from repro_torch.launch import specs as TSP
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import model as TM
from repro_torch.models.params import tree_map
from repro_torch.models.rwkv6 import wkv_scan
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import (HBM_BW, IB_BW, PEAK_BF16_FLOPS, Roofline,
                                  Tracer, analyze_trace, count_ops,
                                  materializes_shape, repeat)

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _trace(fn, *args):
    with Tracer() as tr:
        out = fn(*args)
    return out, tr.trace


# -- hlo_analysis.py's tests ----------------------------------------------------

def test_dot_flops_single():
    m, k, n = 128, 256, 64
    _, tr = _trace(lambda a, b: a @ b, _meta(m, k), _meta(k, n))
    assert tr.flops == 2.0 * m * k * n


def test_batched_dot_flops():
    b, m, k, n = 4, 32, 64, 16
    _, tr = _trace(lambda a, c: torch.einsum("bmk,bkn->bmn", a, c),
                   _meta(b, m, k), _meta(b, k, n))
    assert tr.flops == 2.0 * b * m * k * n


@pytest.mark.parametrize("grad", [False, True])
def test_scan_trip_count_multiplies_flops(grad):
    """``repeat``'s body counted once and scaled by the trip count, on meta
    (with autograd, forward and backward); the same counts as the plain
    loop on CPU tensors (FLOPs and bytes exactly: each step runs the same
    ops on the same shapes)."""
    m, k, n, trips = 64, 64, 64, 12

    def run(dev):
        a = torch.ones((m, k), device=dev, requires_grad=grad)
        bs = torch.ones((trips, k, n), device=dev, requires_grad=grad)

        def f(a, bs):
            carry, ys = repeat(trips, lambda c, b: (c @ b, c.sum()), a, bs)
            out = carry.sum() + torch.stack(ys).sum()
            if grad:
                out.backward()
            return out
        return _trace(f, a, bs)[1]

    scaled, plain = run("meta"), run("cpu")
    fwd = 2.0 * m * k * n * trips
    assert scaled.flops == plain.flops == (3 * fwd if grad else fwd)
    assert scaled.flops_once < scaled.flops
    if not grad:
        assert scaled.hbm_bytes == plain.hbm_bytes


def test_roofline_terms_and_dominance():
    r = Roofline(name="x", chips=2, hlo_flops=2 * PEAK_BF16_FLOPS,
                 hbm_bytes=0.0, collective_bytes=0.0,
                 model_flops=PEAK_BF16_FLOPS)
    assert r.t_compute == 1.0
    assert r.dominant == "compute"
    assert np.isclose(r.roofline_frac, 0.5)
    r2 = Roofline(name="y", chips=1, hlo_flops=0.0, hbm_bytes=HBM_BW * 2,
                  collective_bytes=IB_BW, model_flops=0.0)
    assert r2.dominant == "memory"
    assert np.isclose(r2.t_memory, 2.0) and np.isclose(r2.t_collective, 1.0)


def test_analyze_trace_smoke():
    _, tr = _trace(lambda a: (a @ a.T).sum(), _meta(64, 64))
    roof = analyze_trace("t", tr, chips=1, model_flops=2.0 * 64 ** 3)
    assert roof.hlo_flops >= 2.0 * 64 ** 3
    assert roof.hbm_bytes > 0
    assert roof.collective_bytes == 0.0
    assert set(roof.row()) >= {"t_compute_s", "t_memory_s", "t_collective_s",
                               "dominant", "roofline_frac"}


def test_meta_stand_ins_are_listed():
    """A host read of a meta tensor reads 0 and a data-dependent shape
    takes its bound (every element selected), each listed with its call
    site; on CPU tensors the same ops run as they are and only the read
    is counted."""
    def f(x):
        return int(x.sum()), (x > 0).nonzero(), x[x > 0]
    (v, nz, sel), tr = _trace(f, _meta(3, 4))
    assert v == 0 and tuple(nz.shape) == (12, 2) and tuple(sel.shape) == (12,)
    assert [s["op"] for s in tr.stand_ins] == ["read", "nonzero", "index"]
    assert all("test_torch_roofline.py" in s["site"] for s in tr.stand_ins)
    (v, nz, _), tr = _trace(f, torch.ones(3, 4))
    assert v == 12 and not tr.stand_ins and sum(tr.host_reads.values()) == 1


# -- the port's programs ----------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    own = not dist.is_initialized()
    if own:
        store = tmp_path_factory.mktemp("pg") / "store"
        init_distributed("cpu", init_method=f"file://{store}", rank=0,
                         world_size=1)
    yield make_host_mesh(device="cpu")
    if own:
        dist.destroy_process_group()


def test_hashjoin_step_sorts_once(one_rank):
    """The trace of the hash-join step on a one-rank gloo grid holds one
    sort, the layout's (``test_hashjoin_step_sorts_once``'s invariant,
    read from the trace)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 8, (256, 3)).astype(np.float32)
    y = rng.standard_normal(256).astype(np.float32)
    lsh = T.sample_lsh_params(rng, 4, 3, T.GammaPDF(2.0, 1.0), device="cpu")
    cfg = D.KRRStepConfig(m=4, table_size=1024, lam=0.5, cg_iters=4)
    step = D.make_krr_step_hashjoin(one_rank, cfg, T.RECT)
    _, tr = _trace(step, x, y, lsh)
    assert count_ops(tr, "sort") == 1
    assert tr.collectives["all_to_all"]["calls"] > 0


def _meta_index(n, m, d, table_size, blocked=True):
    lsh = LSHParams(*(_meta(m, d, dtype=dt) for dt in (
        torch.float32, torch.float32, torch.uint32, torch.uint32)))
    op = WLSHOperator(lsh=lsh, bucket=T.RECT, table_size=table_size,
                      fused=True)
    return op.build_index(op.featurize(_meta(n, d)), blocked=blocked)


def test_fused_matvec_never_materializes_the_table():
    """At the ``wlsh_krr`` config's shape (n 2^22, m 64, B 2^23: free on
    meta), the fused matvec op (B2 then the readout) never makes an (m, B)
    float32 tensor (DESIGN.md §3); the split matvec (B3's tables) does."""
    n, m, b = KRR.n_points, KRR.m, KRR.table_size
    idx = _meta_index(n, m, KRR.dim, b)
    beta = _meta(n)
    _, fused = _trace(lambda: BO.bin_fused_matvec_op(idx, beta))
    assert not materializes_shape(fused, (m, b), "f32")
    assert set(fused.kernels) == {"bin_fused_matvec", "bin_readout"}
    _, split = _trace(lambda: BO.table_matvec_op(idx, beta))
    assert materializes_shape(split, (m, b), "f32")


def _to_meta(a):
    if isinstance(a, torch.Tensor):
        return a.to("meta")
    if isinstance(a, tuple):                 # TableIndex, layouts, LSH
        return type(a)(*(_to_meta(f) for f in a))
    return a


def test_kernel_ops_meta_outputs_match_their_contracts():
    """Every kernel op on meta tensors gives its CPU result's shapes and
    dtypes, and credits each kernel it stands for once a call (the fused
    matvec two: B2 and the readout)."""
    rng = np.random.default_rng(1)
    n, m, d, b = 300, 4, 3, 256
    x = torch.from_numpy(rng.uniform(0, 8, (n, d)).astype(np.float32))
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    op = WLSHOperator(lsh=lsh, bucket=T.RECT, table_size=b, fused=True)
    feats = op.featurize(x)
    blocked = op.build_index(feats, blocked=True)
    points = op.build_index(feats, blocked=False)
    lay = blocked.blocked
    cells = torch.full_like(lay.slot_lay, 7)
    used = torch.tensor([8], dtype=torch.int32)
    tables = torch.ones((m, b, 2))
    kv = (torch.ones(2, 5, 2, 8), torch.ones(2, 5, 2, 8),
          torch.ones(2, 5, dtype=torch.int32))
    cases = {
        "featurize": (lambda p, xx: tuple(featurize_op(
            p, T.RECT, xx, table_size=b)), lsh, x),
        "fused": (BO.bin_fused_matvec_op, blocked, torch.ones(n)),
        "loads_blocked": (BO.bin_loads_op, blocked, torch.ones(n, 2)),
        "loads_points": (BO.bin_loads_op, points, torch.ones(n, 2)),
        "readout_blocked": (BO.bin_readout_op, blocked, tables),
        "readout_points": (BO.bin_readout_op, points, tables),
        "combine": (BO.bin_combine_op, blocked.coeff, torch.ones(m, n)),
        "pack": (lambda c, v, u: BO.route_pack_op(
            c, v, u, 8, out_dtype=torch.bfloat16), cells, lay.coeff_lay,
            used),
        "unpack": (BO.route_unpack_op, cells, lay.coeff_lay, torch.ones(8)),
        "decode": (decode_attend_op, torch.ones(2, 4, 8), *kv),
    }
    for name, (fn, *args) in cases.items():
        want = fn(*args)
        got, tr = _trace(fn, *(_to_meta(a) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(t.shape), t.dtype, t.device.type) for t in got] == \
            [(tuple(t.shape), t.dtype, "meta") for t in want], name
        assert tr.kernels and all(k["calls"] == 1 and k["bytes"] > 0
                                  for k in tr.kernels.values()), name
        assert len(tr.kernels) == (2 if name == "fused" else 1), name


def test_rwkv6_scaled_recurrence_counts_as_the_plain_loop():
    """rwkv6's smoke config over 128 steps (two chunks of 64): the prefill
    traced on meta (the chunks and each chunk's steps scaled by
    ``repeat``) counts the FLOPs, bytes and peak of the same prefill run
    step by step on CPU tensors, exactly.  Through the
    train step's backward the FLOPs are exact too; the bytes within 2 %
    (0.13 % measured): every scaled step gets its carry's gradient, where
    the plain loop's last step has none and its first step's carry needs
    no gradient (elementwise work only, so no FLOP moves).  The train
    step's peak within 4 % (3.1 % above the plain loop's measured): the
    stand-ins hold the other steps' kept bytes and the gradient sums
    through the whole backward of the one traced step, where the plain
    loop's peak here is at the end of a chunk's recompute, before the
    sums exist."""
    cfg = TR.smoke_config("rwkv6-1.6b")
    params = TM.init(cfg, torch.Generator().manual_seed(0), torch.float32)
    meta = tree_map(lambda t: t.to("meta"), params)
    tokens = torch.zeros((2, 128), dtype=torch.int64)
    prefill = TS.make_prefill_step(cfg, max_cache_len=128,
                                   dtype=torch.float32)
    with torch.inference_mode():
        _, plain = _trace(prefill, params, {"tokens": tokens})
        _, scaled = _trace(prefill, meta, {"tokens": tokens.to("meta")})
    assert scaled.flops == plain.flops > 0
    assert scaled.hbm_bytes == plain.hbm_bytes
    assert scaled.peak_bytes == plain.peak_bytes
    assert scaled.flops_once < scaled.flops
    batch = {"tokens": tokens, "labels": tokens}
    step = TS.make_train_step(cfg, AdamWConfig(), dtype=torch.float32)
    _, plain = _trace(step, params, adamw_init(params), batch)
    _, scaled = _trace(step, meta, adamw_init(meta),
                       tree_map(lambda t: t.to("meta"), batch))
    assert scaled.flops == plain.flops
    assert abs(scaled.hbm_bytes / plain.hbm_bytes - 1) < 0.02
    assert abs(scaled.peak_bytes / plain.peak_bytes - 1) < 0.04


def test_wkv_scan_scaled_peak_is_the_plain_loops():
    """``wkv_scan`` under autograd (S 256 in four checkpointed chunks of
    64 steps; r, k, v and logw need their gradients), forward and
    backward: traced on meta, where ``repeat`` runs one chunk and one step
    and holds the other steps' kept bytes and gradient sums, its peak is
    the plain loop's on CPU tensors within 1 % (0.42 % above measured;
    holding one step's kept bytes alone reads 43 % of it); the FLOPs exactly and the bytes
    within 2 % (0.09 % measured), as the model's scaled recurrence."""
    b, s, h, d = 2, 256, 4, 16

    def run(dev):
        g = torch.Generator().manual_seed(0)
        r, k, v = (torch.randn((b, s, h, d), generator=g).to(dev)
                   .requires_grad_() for _ in range(3))
        logw = (-torch.rand((b, s, h, d), generator=g)).to(dev) \
            .requires_grad_()
        u = torch.randn((h, d), generator=g).to(dev)

        def f():
            y, state = wkv_scan(r, k, v, logw, u, chunk=64)
            (y.sum() + state.sum()).backward()
        return _trace(f)[1]

    scaled, plain = run("meta"), run("cpu")
    assert scaled.flops == plain.flops > 0
    assert abs(scaled.hbm_bytes / plain.hbm_bytes - 1) < 0.02
    assert abs(scaled.peak_bytes / plain.peak_bytes - 1) < 0.01


# -- against the JAX package's analysis of its own steps ----------------------

def _jax_flops(arch, kind, b, s):
    cfg = JR.smoke_config(arch)
    shape = JShape("s", s, b, kind)
    if kind == "prefill":
        c = jax.jit(JS.make_prefill_step(cfg, max_cache_len=s)).lower(
            JM.abstract_params(cfg, jnp.bfloat16),
            JSP.batch_specs(cfg, shape)).compile()
    else:
        ps = JM.abstract_params(cfg, jnp.float32)
        opt = JAdamWState(step=jax.ShapeDtypeStruct((), jnp.int32), m=ps,
                          v=ps)
        c = jax.jit(JS.make_train_step(cfg, JAdamWConfig(),
                                       dtype=jnp.float32)).lower(
            ps, opt, JSP.batch_specs(cfg, shape)).compile()
    return analyze_hlo_text(c.as_text()).flops


def _port_flops(arch, kind, b, s):
    cfg = TR.smoke_config(arch)
    shape = ShapeSpec("s", s, b, kind)
    if kind == "prefill":
        step = TS.make_prefill_step(cfg, max_cache_len=s)
        with torch.inference_mode():
            _, tr = _trace(step, TM.abstract_params(cfg, torch.bfloat16),
                           TSP.batch_specs(cfg, shape))
    else:
        step = TS.make_train_step(cfg, AdamWConfig(), dtype=torch.float32)
        params = TM.abstract_params(cfg, torch.float32)
        _, tr = _trace(step, params, adamw_init(params),
                       TSP.batch_specs(cfg, shape))
    return tr.flops


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x22b"])
def test_prefill_matmul_flops_match_the_jax_analysis(arch):
    """The smoke prefill's matmul FLOPs on meta equal ``hlo_analysis``'s
    dot FLOPs of the JAX package's prefill compiled on one CPU device:
    both run the same products on the same shapes."""
    assert _port_flops(arch, "prefill", 2, 32) == \
        _jax_flops(arch, "prefill", 2, 32)


@pytest.mark.parametrize("arch,lo,hi", [("gemma3-1b", 0.80, 0.90),
                                        ("mixtral-8x22b", 1.0, 1.06)])
def test_train_matmul_flops_against_the_jax_analysis(arch, lo, hi):
    """The smoke train step (float32 compute, one sequence of 512 tokens:
    a whole cross-entropy chunk, which the JAX step pads a shorter
    sequence up to) against the JAX step's dot FLOPs: the same forward
    products, and a backward whose rematerialization differs.  Eager
    checkpointing recomputes each checkpointed function once in the
    backward; XLA keeps what it can (the JAX step computes the logits
    product once, the port twice) and recomputes other parts more (gemma3's
    attention products 1174 against 1007 MFLOP).  Measured: 0.843
    (gemma3-1b) and 1.030 (mixtral-8x22b) of the JAX count."""
    ratio = _port_flops(arch, "train", 1, 512) / \
        _jax_flops(arch, "train", 1, 512)
    assert lo < ratio < hi, ratio
