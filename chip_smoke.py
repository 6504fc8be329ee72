#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: WLSH-KRR fit,
predict and the distributed step, and LM serving.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout.  Phases, in order; any failure exits
non-zero:

1. Card and build: the card's name and power limit, then the nine kernels
   built by nvcc for sm_90a from ``src/repro_torch/csrc`` (four sources,
   one nvcc each, all started together).
2. Per-kernel parity at full width (d = m = 64), at n = 2^16 and at the main
   phase's n = 2^22, each kernel against its plain PyTorch version on the
   same inputs: featurize keys, slot and sign bitwise, weight and coeff to
   atol 2e-6; matvec and scatter to 1e-5 of the output's max (shared-memory
   atomics sum in another order), at k = 1 and, where the plain version
   fits, k = 4; gather bitwise.  Then the distributed step's kernels on a
   layout at the split geometry (block_n = 64) and one rank's routing: the
   blocked scatter again, the point scatter B5 to 1e-5 of max|out| (global
   atomics), the layout gather B6 and the route pack/unpack B7/B8 bitwise,
   at k = 1 and 4 for n = 2^16 and k = 1 at n = 2^22.  Then flash decode
   B9 at the kv-head shapes of gemma3-1b (KV 1, G 4, D 256; f32 and bf16
   caches), qwen3-14b (KV 8, G 5, D 128, bf16), phi3-mini-3.8b (KV 32, G 1,
   D 96, f32) and command-r-plus-104b (KV 8, G 12, D 128, bf16), each with
   random lengths, one valid row, a wrapped ring and no valid row, T not a
   multiple of the 32-row tile: 1e-5 of max|out| (f32), 1e-4 (bf16).
3. Main phase: ``wlsh_krr_fit`` then ``wlsh_krr_predict`` at the repo's
   ``wlsh_krr`` config (n = 2^22, d = 64, m = 64, B = 2^23, rect,
   Gamma(2, 1), lam = 1, no preconditioner, 32 PCG iterations as the
   config's fixed-iteration step), then 2^20 queries in batches of 2^18.
   Launch counts are reset just before and read just after; a kernel not
   launched fails the run.  Predictions must be finite and match the plain
   path on the first 4096 queries.
4. Small phase (n = 2^12, k = 4 right-hand sides, jacobi and nystrom at
   rank 128): the fit on the card against the same port on the CPU.
6. Distributed step at the same config on a one-rank NCCL group, through
   ``repro_torch.core.distributed``: (a) the psum step with the split
   matvec off the layout (fused=False) and ``make_krr_predict`` on the
   2^20 queries, (b) the psum step with the point kernels
   (blocked_split=False), (c) ``run_krr_step_resilient`` on the bf16 wire
   and ``make_krr_predict_hashjoin`` with and without dedup.  Counts are
   reset before and read after each; a kernel of that path not launched
   fails the run.  Then, outside the counts: (a)'s beta against the f32-wire
   hash join's and the fused step's (1e-4 of max|beta|), the bf16 wire's
   against the f32 wire's (1e-2 relative L2, the JAX package's band),
   (a)'s predictions against phase 3's (1e-4 of max|pred|), and the two
   hash-join predictions bitwise.  Wall time, peak memory, phase split and
   StepStats of each step are printed.
7. LM serving: gemma3-1b at its full config (26 layers, d_model 1152,
   vocab 262144; f32, random weights from the seed) through
   ``repro_torch.launch.serve.generate``: batch 8, a 2048-token prompt, 64
   greedy tokens, so every 512-row local ring wraps and the global caches
   hold 2112 rows.  Counts reset before and read after: B9 must launch 26
   times per decode step.  Then decode_step(prefill(x[:2048]), x[2048])
   against the last logits of prefill(x[:2049]) within 2e-3 of max|logit|,
   and B9's share of a step from its times at the step's two cache shapes.
5. Times, run last: B1-B4 at the main phase's shapes, B5-B8 at phase 6's
   and B9 at the decode_32k shape (T = 32768; the gemma3-1b global layer in
   f32 and bf16, qwen3-14b in bf16), each kernel (CUDA events), its plain
   version, its bound from bytes and operations, and one PyTorch library
   call computing the same function where there is one
   (scaled_dot_product_attention for B9).

Prints the card line, a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MAIN = dict(n=1 << 22, n_query=1 << 20, batch=1 << 18, d=64, m=64,
            table_size=1 << 23, lam=1.0, maxiter=32)
PARITY_NS = (1 << 16, MAIN["n"])
SMALL = dict(n=1 << 12, n_query=1 << 10, k=4, rank=128, lengthscale=16.0,
             lam=0.5)
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
KERNELS = {
    "featurize": ("src/repro_torch/csrc/featurize.cu",
                  "src/repro/kernels/featurize/kernel.py:66"),
    "bin_fused_matvec": ("src/repro_torch/csrc/binning.cu",
                         "src/repro/kernels/binning/kernel.py:187"),
    "bin_scatter_blocked": ("src/repro_torch/csrc/binning.cu",
                            "src/repro/kernels/binning/kernel.py:282"),
    "bin_gather": ("src/repro_torch/csrc/binning.cu",
                   "src/repro/kernels/binning/kernel.py:521"),
    "bin_scatter": ("src/repro_torch/csrc/binning.cu",
                    "src/repro/kernels/binning/kernel.py:92"),
    "bin_gather_blocked": ("src/repro_torch/csrc/binning.cu",
                           "src/repro/kernels/binning/kernel.py:331"),
    "route_pack": ("src/repro_torch/csrc/route.cu",
                   "src/repro/kernels/binning/kernel.py:437"),
    "route_unpack": ("src/repro_torch/csrc/route.cu",
                     "src/repro/kernels/binning/kernel.py:480"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:64"),
}
# the kernels of the distributed step, with the phase-6 path that runs them
DIST_PATHS = {"bin_scatter": "b", "bin_gather_blocked": "a",
              "route_pack": "c", "route_unpack": "c"}
# the kernels of the LM serving path (phase 7)
LM_KERNELS = ("flash_decode",)
# phase 7: gemma3-1b at its full config, f32, seeded random weights
LM = dict(arch="gemma3-1b", batch=8, prompt=2048, gen=64)
# B9 parity shapes (name, B, KV, G, D, T, cache dtype): the kv-head shapes of
# four dense archs, T not a multiple of the kernel's 32-row tile
DECODE_PARITY = (("gemma3-1b", 8, 1, 4, 256, 2112, "float32"),
                 ("gemma3-1b", 8, 1, 4, 256, 2111, "float32"),
                 ("gemma3-1b", 8, 1, 4, 256, 2111, "bfloat16"),
                 ("qwen3-14b", 4, 8, 5, 128, 1001, "bfloat16"),
                 ("phi3-mini-3.8b", 4, 32, 1, 96, 517, "float32"),
                 ("command-r-plus-104b", 4, 8, 12, 128, 777, "bfloat16"))
# B9 times at the decode_32k shape (configs/base.py SHAPES: T = 32768,
# B = 128, or the largest power of two whose cache, the plain version's f32
# copies and a head-expanded copy for the library call fit in DECODE_GIB)
DECODE_TIMED = (("gemma3-1b global", 1, 4, 256, "float32"),
                ("gemma3-1b global", 1, 4, 256, "bfloat16"),
                ("qwen3-14b", 8, 5, 128, "bfloat16"))
DECODE_GIB = 60


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync_clock(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def time_ms(torch, fn, reps: int = 5, warmup: bool = True) -> float:
    """Mean device time of fn() over ``reps`` calls, from CUDA events."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch):
    from repro_torch.kernels import _build
    say("== phase 1: card and build")
    say(f"card: {card_line()}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {time.perf_counter() - t0:.2f} s wall for "
        f"{sorted(built) or 'nothing (already built)'}")
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        if not lib.exists():
            fail(f"{lib} was not built")
        regs = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                .splitlines() if "Used" in ln or "spill" in ln]
        say(f"  {lib.name}: nvcc {' '.join(_build.NVCC_FLAGS[:2])} from "
            f"src/repro_torch/csrc/{name}.cu "
            f"({built.get(name, 0.0):.2f} s); ptxas: {' | '.join(regs)}")


def check_featurize(torch, x, lsh, f, table_size):
    from repro_torch.kernels.featurize import featurize_cuda, featurize_ref
    got = featurize_cuda(x, *lsh, f=f, table_size=table_size)
    want = featurize_ref(x, *lsh, f=f, table_size=table_size)
    torch.cuda.synchronize()
    for name, g, w in zip(("key1", "key2", "slot", "sign"),
                          (got[0], got[1], got[4], got[3]),
                          (want[0], want[1], want[4], want[3])):
        if not torch.equal(g, w):
            fail(f"featurize {f.name} n={x.shape[0]}: {name} differs in "
                 f"{int((g != w).sum())} places")
    err = max(max_err(got[2], want[2]), max_err(got[5], want[5]))
    if err > 2e-6:
        fail(f"featurize {f.name} n={x.shape[0]}: weight/coeff err {err}")
    return got, err


def check_binning(torch, lay, beta, k):
    """Fused matvec and blocked scatter on ``lay`` against their plain
    versions; beta (n,) or (n, k).  Returns (matvec err, scatter err)."""
    from repro_torch.kernels.binning import (bin_fused_matvec_cuda,
                                             bin_scatter_blocked_cuda,
                                             fused_matvec_ref,
                                             scatter_blocked_ref)
    from repro_torch.kernels.binning.ops import _beta_to_layout
    width = lay.num_tiles * lay.block_t
    beta_lay = _beta_to_layout(lay, beta)
    got = bin_fused_matvec_cuda(lay.blk_start, lay.slot_lay, lay.coeff_lay,
                                beta_lay, block_n=lay.block_n,
                                block_t=lay.block_t)
    want = fused_matvec_ref(lay.slot_lay, lay.coeff_lay, beta_lay,
                            width=width)
    e_mv = max_err(got, want)
    lim = 1e-5 * float(want.abs().max())
    del got, want
    if e_mv > lim:
        fail(f"fused matvec k={k}: err {e_mv} > {lim}")
    coeff = lay.coeff_lay if beta.ndim == 1 else lay.coeff_lay[:, None, :]
    contrib = coeff * beta_lay
    got = bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay, contrib,
                                   block_n=lay.block_n, block_t=lay.block_t)
    want = scatter_blocked_ref(lay.slot_lay, contrib, width=width)
    e_sc = max_err(got, want)
    lim = 1e-5 * float(want.abs().max())
    if e_sc > lim:
        fail(f"blocked scatter k={k}: err {e_sc} > {lim}")
    return e_mv, e_sc, got


def check_gather(torch, slot, tables):
    from repro_torch.kernels.binning import bin_gather_cuda, gather_ref
    got = bin_gather_cuda(slot, tables)
    if not torch.equal(got, gather_ref(slot, tables)):
        fail(f"gather {tuple(tables.shape)}: not bitwise equal")


def split_setup(torch, slot, coeff, table_size):
    """The distributed step's arrays at one rank: a layout at the split
    geometry (both groups, then the sorted-segment group dropped once the
    routing has used it) and the hash join's wire cells."""
    from repro_torch.core import distributed as D
    from repro_torch.core.wlsh import BLOCKED_SPLIT_N, build_blocked_layout
    lay = build_blocked_layout(slot, coeff, table_size,
                               block_n=BLOCKED_SPLIT_N, parts="both")
    pt_cell, _, _, cap, _, _ = D._routing_maps(slot, lay, 1, table_size, 2.0)
    cell_lay = D._make_route_plan(pt_cell, lay, cap)
    lay = lay._replace(perm=None, seg_id=None, seg_pt=None,
                       coeff_sorted=None)
    return lay, cell_lay, cap


def check_dist_kernels(torch, slot, coeff, lay, cell_lay, nb, beta,
                       table_size):
    """B5 (to 1e-5 of max|out|), B6, B7 and B8 (bitwise) against their
    plain versions on the same inputs; beta (n,) or (n, k).  Returns B5's
    max error."""
    from repro_torch.kernels.binning import (bin_gather_blocked_cuda,
                                             bin_scatter_cuda,
                                             gather_blocked_ref,
                                             route_pack_cuda, route_pack_ref,
                                             route_unpack_cuda,
                                             route_unpack_ref, scatter_ref)
    from repro_torch.kernels.binning.ops import layout_rows
    k = 1 if beta.ndim == 1 else beta.shape[1]
    contrib = (coeff * beta if beta.ndim == 1
               else coeff[..., None] * beta[None]).contiguous()
    got = bin_scatter_cuda(slot, contrib, table_size)
    tables = scatter_ref(slot, contrib, table_size=table_size)
    e5 = max_err(got, tables)
    lim = 1e-5 * float(tables.abs().max())
    del got, contrib
    if e5 > lim:
        fail(f"point scatter k={k}: err {e5} > {lim}")
    if not torch.equal(bin_gather_blocked_cuda(lay.slot_lay, tables),
                       gather_blocked_ref(lay.slot_lay, tables)):
        fail(f"layout gather k={k}: not bitwise equal")
    del tables
    beta_lay = layout_rows(lay, beta)
    coeff_lay = lay.coeff_lay if k == 1 and beta.ndim == 1 else \
        lay.coeff_lay[..., None]
    contrib_lay = coeff_lay * beta_lay
    del beta_lay
    send = route_pack_ref(cell_lay, contrib_lay, num_cells=nb)
    if not torch.equal(route_pack_cuda(cell_lay, contrib_lay, nb), send):
        fail(f"route pack k={k}: not bitwise equal")
    del contrib_lay
    if not torch.equal(route_unpack_cuda(cell_lay, lay.coeff_lay, send),
                       route_unpack_ref(cell_lay, lay.coeff_lay, send)):
        fail(f"route unpack k={k}: not bitwise equal")
    return e5


def phase_parity(torch, x, xq, seed):
    import repro_torch.core as T
    from repro_torch.core.wlsh import build_blocked_layout
    from repro_torch.kernels.featurize import featurize_cuda
    say(f"== phase 2: per-kernel parity at full width (d={MAIN['d']}, "
        f"m={MAIN['m']})")
    errs = {}
    for n in PARITY_NS:
        table_size = MAIN["table_size"] if n == MAIN["n"] else \
            T.default_table_size(n)
        rng = np.random.default_rng(seed + n)
        lsh = T.sample_lsh_params(rng, MAIN["m"], MAIN["d"], T.GammaPDF(),
                                  device=x.device)
        fnames = ("rect",) if n == MAIN["n"] else ("rect", "tent", "smooth")
        for fname in fnames:
            feats, e_f = check_featurize(torch, x[:n], lsh,
                                         T.get_bucket_fn(fname), table_size)
            say(f"  n={n} featurize[{fname}]: keys/slot/sign bitwise, "
                f"weight/coeff max err {e_f:.3g}")
        slot, coeff = feats[4], feats[5]
        del feats
        lay = build_blocked_layout(slot, coeff, table_size)
        beta = torch.randn(n, device=x.device)
        e_mv, e_sc, tables = check_binning(torch, lay, beta, 1)
        say(f"  n={n} k=1 fused matvec err {e_mv:.3g}, blocked scatter "
            f"err {e_sc:.3g} (limit 1e-5 of max|out|)")
        q_slot = featurize_cuda(xq[:MAIN["batch"]], *lsh, f=T.RECT,
                                table_size=table_size)[4]
        if n == MAIN["n"]:
            errs.update(featurize=e_f, bin_fused_matvec=e_mv,
                        bin_scatter_blocked=e_sc, bin_gather=0.0)
        check_gather(torch, q_slot, tables[:, :table_size].contiguous())
        say(f"  n={n} gather (m, B) bitwise over {q_slot.shape[1]} queries")
        del tables
        if n != MAIN["n"]:
            beta4 = torch.randn(n, 4, device=x.device)
            e_mv, e_sc, tables4 = check_binning(torch, lay, beta4, 4)
            say(f"  n={n} k=4 fused matvec err {e_mv:.3g}, blocked "
                f"scatter err {e_sc:.3g}")
            t4 = tables4[..., :table_size].transpose(1, 2).contiguous()
            check_gather(torch, q_slot, t4)
            say(f"  n={n} gather (m, B, 4) bitwise")
            del tables4, t4
        else:
            say(f"  n={n} k=4: not compared (the plain version's int64 "
                f"index and (m, k, L) temporaries need about 55 GB)")
        del lay
        lay, cell_lay, nb = split_setup(torch, slot, coeff, table_size)
        for k in ((1, 4) if n != MAIN["n"] else (1,)):
            b = beta if k == 1 else torch.randn(n, k, device=x.device)
            e_mv, e_sc, _ = check_binning(torch, lay, b, k)
            e5 = check_dist_kernels(torch, slot, coeff, lay, cell_lay, nb, b,
                                    table_size)
            say(f"  n={n} k={k} split geometry (block_n={lay.block_n}, "
                f"{nb} wire cells): fused matvec err {e_mv:.3g}, blocked "
                f"scatter err {e_sc:.3g}, point scatter err {e5:.3g}; "
                f"layout gather, route pack, route unpack bitwise")
            if n == MAIN["n"]:
                errs.update(bin_scatter=e5, bin_gather_blocked=0.0,
                            route_pack=0.0, route_unpack=0.0)
        del lay, cell_lay, slot, coeff
        torch.cuda.empty_cache()
    return errs


def phase_main(torch, data, seed):
    import repro_torch.core as T
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.binning import gather_ref
    from repro_torch.kernels.featurize import featurize_ref
    say("== phase 3: main path at the wlsh_krr config")
    x, y, xq = data
    lsh = T.sample_lsh_params(np.random.default_rng(seed), MAIN["m"],
                              MAIN["d"], T.GammaPDF(2.0, 1.0),
                              device=x.device)
    spec = T.WLSHKernelSpec(bucket=T.RECT, pdf=T.GammaPDF(2.0, 1.0))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = sync_clock(torch)
    model = T.wlsh_krr_fit(lsh, x, y, spec, lam=MAIN["lam"],
                           table_size=MAIN["table_size"], tol=0.0, atol=0.0,
                           maxiter=MAIN["maxiter"], device=x.device)
    t1 = sync_clock(torch)
    pred = T.wlsh_krr_predict(model, xq, batch_size=MAIN["batch"])
    t2 = sync_clock(torch)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tel = model.telemetry
    phases = dict(tel["phase_seconds"], predict=t2 - t1)
    say("  wall s (synchronized): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items())
        + f"; fit total {t1 - t0:.4f}")
    hist = tel["resnorm_history"][:, 0]
    bnorm = float(torch.linalg.vector_norm(y))
    say(f"  PCG iterations {tel['iters']}, resnorm {hist[0]:.4g} -> "
        f"{hist[-1]:.4g} (relative {hist[-1] / bnorm:.3g})")
    say(f"  peak device memory {peak / 2**30:.2f} GiB")
    say(f"  launches {counts}")
    missing = [k for k, v in counts.items()
               if v <= 0 and k not in DIST_PATHS and k not in LM_KERNELS]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    if tel["iters"] != MAIN["maxiter"] or not hist[-1] < hist[0]:
        fail(f"PCG did not run its {MAIN['maxiter']} iterations down")
    if pred.shape != (MAIN["n_query"],) or not bool(torch.isfinite(pred).all()):
        fail(f"predictions: shape {tuple(pred.shape)} or non-finite")
    # the plain path on the first queries: plain featurize + plain gather
    nq = 4096
    feats = featurize_ref(xq[:nq], *model.lsh, f=T.RECT,
                          table_size=model.table_size)
    plain = (feats[5] * gather_ref(feats[4], model.tables)).mean(0)
    err = max_err(pred[:nq], plain)
    say(f"  predictions finite, shape {tuple(pred.shape)}; plain path on "
        f"{nq} queries max err {err:.3g}")
    if err > 1e-5:
        fail(f"main predictions differ from the plain path by {err}")
    return model, counts, phases, pred


def phase_small(torch, dev, seed):
    import repro_torch.core as T
    from repro_torch.data import make_regression
    say("== phase 4: small phase, card against CPU (n = 2^12, k = 4)")
    n, k = SMALL["n"], SMALL["k"]
    x, y, xq, _ = make_regression(n, SMALL["n_query"], MAIN["d"], rough=0.5,
                                  seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    ys = np.stack([y] + [y + 0.1 * rng.standard_normal(n).astype(np.float32)
                         for _ in range(k - 1)], axis=1)
    lsh = T.sample_lsh_params(rng, MAIN["m"], MAIN["d"], T.GammaPDF(),
                              SMALL["lengthscale"])
    spec = T.WLSHKernelSpec(bucket=T.RECT)
    for precond in ("jacobi", "nystrom"):
        kw = dict(lam=SMALL["lam"], tol=1e-6, maxiter=400, precond=precond,
                  precond_rank=SMALL["rank"])
        gpu = T.wlsh_krr_fit(lsh, x, ys, spec, device=dev, **kw)
        cpu = T.wlsh_krr_fit(lsh, x, ys, spec, device="cpu", **kw)
        p_gpu = T.wlsh_krr_predict(gpu, xq).cpu()
        p_cpu = T.wlsh_krr_predict(cpu, xq)
        err = max_err(p_gpu, p_cpu)
        scale = float(p_cpu.abs().max())
        say(f"  {precond}: iterations card {gpu.telemetry['iters']} / cpu "
            f"{cpu.telemetry['iters']}; predictions max err {err:.3g} "
            f"(max |pred| {scale:.3g}, limit 1e-4)")
        if not err <= 1e-4:
            fail(f"small phase {precond}: card and CPU differ by {err}")


def phase_distributed(torch, data, seed, main_pred):
    """Phase 6: the distributed step on a one-rank NCCL group."""
    import torch.distributed as dist
    import repro_torch.core as T
    from repro_torch.core import distributed as D
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    say("== phase 6: distributed step at the wlsh_krr config, one NCCL rank")
    x, y, xq = data
    dev = init_distributed(x.device)
    mesh = make_host_mesh(device=dev)
    say(f"  process group: {dist.get_backend()}, world {dist.get_world_size()}"
        f", grid {mesh.data} data x {mesh.model} model")
    lsh = T.sample_lsh_params(np.random.default_rng(seed), MAIN["m"],
                              MAIN["d"], T.GammaPDF(2.0, 1.0), device=dev)
    base = dict(m=MAIN["m"], table_size=MAIN["table_size"], lam=MAIN["lam"],
                cg_iters=MAIN["maxiter"])
    counts, report = {}, {}

    def run(path, label, fn, need=()):
        """One step, synchronised; counts reset before and read after when
        ``need`` names the kernels this path must launch."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = sync_clock(torch)
        out = fn()
        wall = sync_clock(torch) - t0
        c = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ran = {k: v for k, v in c.items() if v}
        say(f"  ({path}) {label}: wall {wall:.4f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches {ran}")
        missing = [k for k in need if c[k] <= 0]
        if missing:
            fail(f"phase 6 ({path}): kernels not launched: {missing}")
        if need:
            counts[path] = c
        report[path] = dict(wall_s=wall, peak_gib=peak / 2**30)
        return out

    def split(step):
        ms = step.phase_ms()
        return ", ".join(f"{k} {v:.2f}" for k, v in ms.items())

    # (a) psum, split matvec off the layout: B1, B3, B6
    cfg_a = D.KRRStepConfig(**base, fused=False, blocked_split=True)
    step_a = D.make_krr_step(mesh, cfg_a, T.RECT)
    predict_a = D.make_krr_predict(mesh, cfg_a, T.RECT)

    def path_a():
        beta, res, tables = step_a(x, y, lsh)
        phases = split(step_a)
        return beta, res, predict_a(xq, lsh, tables), phases

    beta_a, res_a, pred_a, ph = run(
        "a", "psum step fused=False blocked_split=True + predict 2^20",
        path_a, ("featurize", "bin_scatter_blocked", "bin_gather_blocked"))
    say(f"      step split ms: {ph}; resnorm {float(res_a):.4g}")

    # (b) psum with the point kernels: B5, B4
    step_b = D.make_krr_step(mesh, D.KRRStepConfig(
        **base, fused=False, blocked_split=False), T.RECT)
    beta_b, res_b, _ = run("b", "psum step blocked_split=False",
                           lambda: step_b(x, y, lsh),
                           ("featurize", "bin_scatter", "bin_gather"))
    say(f"      step split ms: {split(step_b)}; resnorm {float(res_b):.4g}")

    # (c) hash join on the bf16 wire with the recovery ladder, then its
    # predictions with and without dedup: B7, B8
    cfg_c = D.KRRStepConfig(**base)
    pred_hj = {}

    def path_c():
        beta, res, table, stats = D.run_krr_step_resilient(
            mesh, cfg_c, T.RECT, x, y, lsh, payload_dtype=torch.bfloat16)
        for dedup in (True, False):
            pred_hj[dedup] = D.make_krr_predict_hashjoin(
                mesh, cfg_c, T.RECT, payload_dtype=torch.bfloat16,
                dedup=dedup)(xq, lsh, table)
        return beta, res, stats

    beta_c, res_c, stats_c = run(
        "c", "hash-join resilient step (bf16 wire) + predict dedup on/off",
        path_c, ("featurize", "route_pack", "route_unpack"))
    say(f"      resnorm {float(res_c):.4g}; StepStats overflow_dropped "
        f"{int(stats_c.overflow_dropped)}, wire_nonfinite "
        f"{int(stats_c.wire_nonfinite)}")

    # comparisons, outside the counted paths
    step_hj = D.make_krr_step_hashjoin(mesh, cfg_c, T.RECT,
                                       payload_dtype=torch.float32)
    beta_hj, _, _, stats_hj = run("hj-f32", "hash-join step (f32 wire)",
                                  lambda: step_hj(x, y, lsh))
    say(f"      step split ms: {split(step_hj)}; StepStats "
        f"{int(stats_hj.overflow_dropped)}, {int(stats_hj.wire_nonfinite)}")
    step_f = D.make_krr_step(mesh, cfg_c, T.RECT)
    beta_f, _, _ = run("fused", "psum step fused (one data rank)",
                       lambda: step_f(x, y, lsh))
    say(f"      step split ms: {split(step_f)}")
    scale = float(beta_a.abs().max())
    checks = {
        "beta (a) vs f32 hash join": (max_err(beta_a, beta_hj) / scale, 1e-4),
        "beta (a) vs fused step": (max_err(beta_a, beta_f) / scale, 1e-4),
        "beta (b) vs (a)": (max_err(beta_b, beta_a) / scale, 1e-4),
        "beta bf16 vs f32 wire, rel L2": (float(
            torch.linalg.vector_norm(beta_c - beta_hj)
            / torch.linalg.vector_norm(beta_hj)), 1e-2),
        "pred (a) vs phase 3": (max_err(pred_a, main_pred)
                                / float(main_pred.abs().max()), 1e-4),
        "pred hash join (bf16) vs (a), rel L2": (float(
            torch.linalg.vector_norm(pred_hj[True] - pred_a)
            / torch.linalg.vector_norm(pred_a)), 1e-2),
    }
    for name, (err, lim) in checks.items():
        say(f"  {name}: {err:.3g} (limit {lim:g})")
        if not err <= lim:
            fail(f"phase 6: {name} {err} > {lim}")
    if not torch.equal(pred_hj[True], pred_hj[False]):
        fail("phase 6: hash-join predictions differ with and without dedup")
    say("  hash-join predictions with and without dedup: bitwise equal")
    if not all(bool(torch.isfinite(t).all()) for t in
               (beta_a, beta_b, beta_c, pred_a, pred_hj[True])):
        fail("phase 6: non-finite betas or predictions")
    dist.destroy_process_group()
    return lsh, beta_a, counts


def dist_times(torch, x, lsh, beta, ts):
    """B5-B8 at phase 6's shapes (n = 2^22, one rank's routing), with
    their plain versions and library calls."""
    import repro_torch.core as T
    from repro_torch.kernels.binning import (bin_gather_blocked_cuda,
                                             bin_scatter_cuda,
                                             gather_blocked_ref,
                                             route_pack_cuda, route_pack_ref,
                                             route_unpack_cuda,
                                             route_unpack_ref, scatter_ref)
    from repro_torch.kernels.binning.ops import layout_rows
    from repro_torch.kernels.featurize import featurize_cuda
    m = lsh.m
    feats = featurize_cuda(x, *lsh, f=T.RECT, table_size=ts)
    slot, coeff = feats[4], feats[5]
    del feats
    rows = {}
    contrib = (coeff * beta).contiguous()
    run = lambda: bin_scatter_cuda(slot, contrib, ts)
    tables = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: scatter_ref(slot, contrib, table_size=ts),
                    reps=1, warmup=False)
    flat = (slot.long() + ts * torch.arange(m, device=x.device)[:, None]
            ).view(-1)
    acc = torch.zeros(m * ts, device=x.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, flat, contrib.view(-1)))
    rows["bin_scatter"] = (ms, plain, bound(nbytes(slot, contrib, tables),
                                            contrib.numel()), lib)
    del flat, acc, contrib
    torch.cuda.empty_cache()

    lay, cell_lay, nb = split_setup(torch, slot, coeff, ts)
    del slot, coeff
    L = lay.slot_lay.shape[1]
    real = lay.src < x.shape[0]
    head = real.clone()
    head[:, 1:] &= (lay.slot_lay[:, 1:] != lay.slot_lay[:, :-1]) | \
        ~real[:, :-1]
    distinct = int(head.sum())
    del real, head
    run = lambda: bin_gather_blocked_cuda(lay.slot_lay, tables)
    out = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: gather_blocked_ref(lay.slot_lay, tables),
                    reps=1, warmup=False)
    idx = lay.slot_lay.long()
    lib = time_ms(torch, lambda: torch.gather(tables, 1, idx))
    rows["bin_gather_blocked"] = (ms, plain, bound(
        nbytes(lay.slot_lay, out) + 4 * distinct), lib)
    say(f"  split layout: L = {L} per instance, {distinct} distinct "
        f"(instance, slot) buckets, {nb} wire cells")
    del out, idx, tables
    torch.cuda.empty_cache()

    contrib_lay = lay.coeff_lay * layout_rows(lay, beta)
    run = lambda: route_pack_cuda(cell_lay, contrib_lay, nb)
    send = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: route_pack_ref(cell_lay, contrib_lay,
                                                  num_cells=nb),
                    reps=1, warmup=False)
    # the library call adds the real positions only: sentinels sent to one
    # spare cell would all add to one address
    real = (cell_lay < nb).view(-1).nonzero()[:, 0]
    cells, vals = cell_lay.view(-1)[real].long(), contrib_lay.view(-1)[real]
    del real
    acc = torch.zeros(nb, device=x.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, cells, vals))
    rows["route_pack"] = (ms, plain, bound(nbytes(cell_lay, contrib_lay,
                                                  send),
                                           contrib_lay.numel()), lib)
    del acc, contrib_lay, cells, vals
    torch.cuda.empty_cache()

    run = lambda: route_unpack_cuda(cell_lay, lay.coeff_lay, send)
    out = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: route_unpack_ref(cell_lay, lay.coeff_lay,
                                                    send),
                    reps=1, warmup=False)
    idx = cell_lay.long()
    back = torch.cat([send, send.new_zeros(int(idx.max()) + 1 - nb)])
    lib = time_ms(torch, lambda: torch.gather(back.expand(m, -1), 1, idx))
    rows["route_unpack"] = (ms, plain, bound(
        nbytes(cell_lay, lay.coeff_lay, out) + 4 * distinct,
        out.numel()), lib)
    say("  (library calls: index_add_ for B5 and B7, torch.gather for B6 "
        "and B8 -- B8's without the coeff product)")
    return rows


def decode_inputs(torch, dev, b, kv, g, d, t, dtype, seed, lens="random"):
    """Random q, k, v and a validity mask of one of four kinds: random
    lengths, one valid row, a wrapped ring (all valid), no valid row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kv, g, d), generator=gen, device=dev)
    k = torch.randn((b, t, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kv, d), generator=gen, device=dev).to(dtype)
    rows = torch.arange(t, device=dev)[None]
    if lens == "random":
        n = torch.randint(1, t + 1, (b, 1), generator=gen, device=dev)
        valid = rows < n
    elif lens == "one":
        valid = (rows == t // 2).expand(b, -1)
    elif lens == "wrapped":
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        valid = torch.zeros((b, t), dtype=torch.bool, device=dev)
    return q, k, v, valid.to(torch.int32).contiguous()


def phase_parity_decode(torch, dev, seed):
    """B9 against its plain version at the kv-head shapes of four dense
    archs: 1e-5 of max|out| with an f32 cache, 1e-4 with bf16."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    say("== phase 2: flash decode (B9) against its plain version")
    worst = 0.0
    for i, (arch, b, kv, g, d, t, dt) in enumerate(DECODE_PARITY):
        dtype = getattr(torch, dt)
        lim_rel = 1e-5 if dtype == torch.float32 else 1e-4
        errs = []
        for lens in ("random", "one", "wrapped", "none"):
            args = decode_inputs(torch, dev, b, kv, g, d, t, dtype,
                                 seed + i, lens)
            got = flash_decode_cuda(*args)
            want = flash_decode_ref(*args)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"flash decode {arch} T={t} {dt} {lens}: non-finite")
            err = max_err(got, want)
            lim = lim_rel * float(want.abs().max())
            if not err <= lim:
                fail(f"flash decode {arch} T={t} {dt} {lens}: err {err} > "
                     f"{lim}")
            errs.append(err)
            worst = max(worst, err)
        say(f"  {arch} B={b} KV={kv} G={g} D={d} T={t} {dt}: max err "
            f"{max(errs):.3g} over random lengths / one valid row / wrapped "
            f"ring / no valid row (limit {lim_rel:g} of max|out|)")
    return worst


def phase_lm(torch, dev, seed):
    """Phase 7: gemma3-1b at its full config served through
    repro_torch.launch.serve.generate, then prefill/decode consistency."""
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as TM
    from repro_torch.models.attention import ring_valid
    cfg = registry.get_config(LM["arch"])
    b, s, n_gen = LM["batch"], LM["prompt"], LM["gen"]
    say(f"== phase 7: LM serving, {cfg.name} at its full config (f32, "
        f"seeded random weights), batch {b}, prompt {s}, {n_gen} greedy "
        f"tokens")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = sync_clock(torch)
    params = TM.init(cfg, gen, torch.float32)
    say(f"  {TM.count_params(cfg):,} parameters ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"head_dim {cfg.head_dim}, vocab {cfg.vocab_size}) made in "
        f"{sync_clock(torch) - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    ids, t_pre, t_dec = generate(cfg, params, tokens, n_gen,
                                 generator=gen)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = n_gen - 1
    per_step = t_dec / steps * 1e3
    say(f"  prefill {b}x{s}: {t_pre * 1e3:.2f} ms; decode {steps} steps: "
        f"{per_step:.3f} ms per step, {b * steps / t_dec:.1f} tok/s; peak "
        f"device memory {peak:.2f} GiB")
    say(f"  launches {dict((k, v) for k, v in counts.items() if v)}")
    if counts["flash_decode"] != cfg.n_layers * steps:
        fail(f"phase 7: flash_decode launched {counts['flash_decode']} "
             f"times, not {cfg.n_layers} per decode step x {steps}")
    if ids.shape != (b, n_gen) or not bool(
            ((ids >= 0) & (ids < cfg.vocab_size)).all()):
        fail(f"phase 7: generated ids of shape {tuple(ids.shape)} out of "
             f"range")
    say(f"  sample ids {ids[0, :8].tolist()} ...")

    # prefill/decode consistency at full width: B9 on the rows written by the
    # prefill (every local ring wrapped, global caches 2049 of 2112 valid)
    with torch.inference_mode():
        x = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                          device=dev)
        ref, _, _ = TM.prefill(cfg, params, {"tokens": x},
                               dtype=torch.float32)
        _, cache, pos = TM.prefill(cfg, params, {"tokens": x[:, :s]},
                                   max_cache_len=s + n_gen,
                                   dtype=torch.float32)
        got, _ = TM.decode_step(cfg, params, cache, x[:, s:], pos,
                                dtype=torch.float32)
    if not (bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(ref).all())):
        fail("phase 7: non-finite logits")
    err = max_err(got, ref) / float(ref.abs().max())
    say(f"  decode_step(prefill(x[:{s}]), x[{s}]) vs prefill(x[:{s + 1}]) "
        f"last logits: {err:.3g} of max|logit| {float(ref.abs().max()):.4g} "
        f"(limit 2e-3)")
    if not err <= 2e-3:
        fail(f"phase 7: prefill/decode consistency {err} > 2e-3")

    # B9's share of a decode step, at the step's two cache shapes
    valid = {}
    b9 = {}
    for i, slot in enumerate(cfg.layer_pattern):
        kind = "global" if slot.window == 0 else "local"
        if kind in b9:
            continue
        ck, cv = cache[f"slot{i}"]["k"][0], cache[f"slot{i}"]["v"][0]
        valid[kind] = ring_valid(pos + 1, ck.shape[1])
        q = torch.randn((b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                         cfg.head_dim), generator=gen, device=dev)
        args = (q, ck, cv, valid[kind])
        ms = time_ms(torch, lambda: flash_decode_cuda(*args), reps=20)
        plain = time_ms(torch, lambda: flash_decode_ref(*args), reps=5)
        b9[kind] = (ms, plain, ck.shape[1], nbytes(q, ck, cv, valid[kind], q))
    n_global = sum(1 for sl in cfg.layer_pattern if sl.window == 0)
    n_local = cfg.n_layers - n_global
    b9_step = n_global * b9["global"][0] + n_local * b9["local"][0]
    for kind, (ms, plain, tc, nb) in b9.items():
        say(f"  B9 at the {kind} cache (T = {tc}): {ms:.4f} ms (bound "
            f"{bound(nb)[0]:.4f} ms), plain {plain:.4f} ms")
    w_bytes = 4 * TM.count_params(cfg)
    c_bytes = sum(t.numel() * t.element_size() for sl in cache.values()
                  for t in sl.values())
    say(f"  B9 per decode step: {n_global} x global + {n_local} x local = "
        f"{b9_step:.3f} ms, {b9_step / per_step:.1%} of the step; the "
        f"step's byte bound (weights {w_bytes / 1e9:.2f} GB + caches "
        f"{c_bytes / 1e9:.3f} GB once) {bound(w_bytes + c_bytes)[0]:.3f} ms")
    profile_decode(torch, cfg, params, cache, x[:, s:], pos + 1)
    del params, cache
    torch.cuda.empty_cache()
    return counts


def profile_decode(torch, cfg, params, cache, tok, pos, steps: int = 3):
    """torch.profiler over a few decode steps: kernels launched per step,
    the device's busy time (the sum of kernel times: one stream) against the
    wall, and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_decode_step
    decode = make_decode_step(cfg, dtype=torch.float32)
    with torch.inference_mode():
        decode(params, cache, tok, pos)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = sync_clock(torch)
            for i in range(steps):
                decode(params, cache, tok, pos + 1 + i)
            wall = (sync_clock(torch) - t0) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        say("  profiler: no device events recorded; device busy share not "
            "measured")
        return
    busy = sum(us for _, us in by_name.values()) / 1e3 / steps
    launches = sum(n for n, _ in by_name.values()) / steps
    say(f"  profiled decode step (torch.profiler, {steps} steps): wall "
        f"{wall:.3f} ms, {launches:.0f} kernels, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}; idle {1 - busy / wall:.1%})")
    b9 = {part: sum(us for name, (_, us) in by_name.items()
                    if f"{part}_kernel" in name) / 1e3 / steps
          for part in ("split", "combine")}
    say(f"    B9 on the device: split {b9['split']:.3f} + combine "
        f"{b9['combine']:.3f} ms/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        say(f"    {us / 1e3 / steps:.3f} ms/step in {n // steps} x "
            f"{name[:90]}")


def decode_batch(torch, kv, g, d, dtype):
    """The decode_32k batch for one kv-head shape: 128, halved until the
    cache, the plain version's f32 copies and a head-expanded copy for the
    library call fit in DECODE_GIB."""
    elt = torch.empty((), dtype=dtype).element_size()
    b = 128
    while b > 1:
        cache = 2 * b * 32768 * kv * d * elt
        if cache * (1 + 4 / elt + g) <= DECODE_GIB * 2**30:
            break
        b //= 2
    return b


def decode_times(torch, dev, seed):
    """B9 at the decode_32k shape, against its plain version, its byte
    bound and scaled_dot_product_attention (enable_gqa, boolean mask) on
    the same cache laid out (B, KV, T, D)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_ref)
    t = 32768
    rows = []
    for i, (label, kv, g, d, dt) in enumerate(DECODE_TIMED):
        dtype = getattr(torch, dt)
        b = decode_batch(torch, kv, g, d, dtype)
        q, k, v, valid = decode_inputs(torch, dev, b, kv, g, d, t, dtype,
                                       seed + i)
        run = lambda: flash_decode_cuda(q, k, v, valid)
        out = run()
        ms = time_ms(torch, run, reps=10)
        plain = time_ms(torch, lambda: flash_decode_ref(q, k, v, valid),
                        reps=3)
        b_ms, b_by = bound(nbytes(q, k, v, valid, out),
                           4.0 * b * kv * g * t * d)
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        del k, v
        torch.cuda.empty_cache()
        qs = q.reshape(b, kv * g, 1, d).to(dtype)
        mask = (valid > 0)[:, None, None, :]
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True), reps=3)
        say(f"  B9 decode_32k {label} {dt}: B={b} KV={kv} G={g} D={d} "
            f"T={t}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, "
            f"scaled_dot_product_attention {lib:.4f} ms")
        rows.append((ms, plain, (b_ms, b_by), lib))
        del q, kt, vt, valid, out, qs, mask
        torch.cuda.empty_cache()
    return rows


def phase_times(torch, data, model, counts, errs, dist_state, lm_counts,
                seed):
    import repro_torch.core as T
    from repro_torch.kernels.binning import (bin_fused_matvec_cuda,
                                             bin_gather_cuda,
                                             bin_scatter_blocked_cuda,
                                             fused_matvec_ref, gather_ref,
                                             scatter_blocked_ref)
    from repro_torch.kernels.binning.ops import (_beta_to_layout,
                                                 bin_fused_matvec_op)
    from repro_torch.kernels.featurize import featurize_cuda, featurize_ref
    from repro_torch.core.wlsh import TableIndex, build_blocked_layout
    say("== phase 5: times at the main phase's shapes")
    x, _, xq = data
    lsh, ts = model.lsh, model.table_size
    n, d, m = x.shape[0], x.shape[1], lsh.m
    rows = {}

    run = lambda: featurize_cuda(x, *lsh, f=T.RECT, table_size=ts)
    feats = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: featurize_ref(x, *lsh, f=T.RECT,
                                                 table_size=ts),
                    reps=1, warmup=False)
    rows["featurize"] = (ms, plain, bound(nbytes(x, *lsh, *feats),
                                          5.0 * m * n * d), None)
    slot, coeff = feats[4], feats[5]
    del feats
    lay = build_blocked_layout(slot, coeff, ts)
    width = lay.num_tiles * lay.block_t
    beta_lay = _beta_to_layout(lay, model.beta)
    args = (lay.blk_start, lay.slot_lay, lay.coeff_lay, beta_lay)
    run = lambda: bin_fused_matvec_cuda(*args, block_n=lay.block_n,
                                        block_t=lay.block_t)
    out = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: fused_matvec_ref(
        lay.slot_lay, lay.coeff_lay, beta_lay, width=width), reps=1,
        warmup=False)
    rows["bin_fused_matvec"] = (ms, plain, bound(nbytes(*args, out),
                                                 3.0 * out.numel()), None)
    del out
    # the whole matvec op of a PCG iteration: beta into the layout, the
    # kernel, the map back through inv_pos and the mean over instances
    idx = TableIndex(slot=slot, sign=coeff, weight=coeff, coeff=coeff,
                     table_size=ts, blocked=lay)
    op_ms = time_ms(torch, lambda: bin_fused_matvec_op(idx, model.beta))
    op_bound, _ = bound(nbytes(slot, coeff, model.beta, model.beta))
    say(f"  whole matvec op: {op_ms:.4f} ms against {op_bound:.4f} ms for "
        f"its point-order inputs (slot, coeff, beta) and output")
    del idx
    contrib = lay.coeff_lay * beta_lay
    run = lambda: bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay,
                                           contrib, block_n=lay.block_n,
                                           block_t=lay.block_t)
    tables = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: scatter_blocked_ref(
        lay.slot_lay, contrib, width=width), reps=1, warmup=False)
    flat = (lay.slot_lay.long() + width * torch.arange(
        m, device=x.device)[:, None]).view(-1)
    acc = torch.zeros(m * width, device=x.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, flat, contrib.view(-1)))
    rows["bin_scatter_blocked"] = (
        ms, plain, bound(nbytes(lay.blk_start, lay.slot_lay, contrib,
                                tables), contrib.numel()), lib)
    del flat, acc, tables, contrib, beta_lay, lay, slot, coeff
    torch.cuda.empty_cache()

    q_slot = featurize_cuda(xq[:MAIN["batch"]], *lsh, f=T.RECT,
                            table_size=ts)[4]
    run = lambda: bin_gather_cuda(q_slot, model.tables)
    out = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: gather_ref(q_slot, model.tables))
    idx = q_slot.long()
    lib = time_ms(torch, lambda: torch.gather(model.tables, 1, idx))
    rows["bin_gather"] = (ms, plain, bound(nbytes(q_slot, out, out)), lib)

    del q_slot, idx, out
    rows.update(dist_times(torch, x, dist_state[0], dist_state[1], ts))
    torch.cuda.empty_cache()
    rows["flash_decode"] = decode_times(torch, data[0].device, seed)[0]
    entries = []
    for name, (ms, plain, (b_ms, b_by), lib) in rows.items():
        src, replaces = KERNELS[name]
        path = DIST_PATHS.get(name)
        launches = (lm_counts[name] if name in LM_KERNELS
                    else counts[name] if path is None
                    else dist_state[2][path][name])
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches,
                            max_abs_err=errs[name], ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        say(f"  {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, library "
            f"{'-' if lib is None else f'{lib:.4f} ms'}")
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              f"(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data import make_regression

    t_start = time.perf_counter()
    phase_build(torch)
    t0 = time.perf_counter()
    x, y, xq, _ = make_regression(MAIN["n"], MAIN["n_query"], MAIN["d"],
                                  rough=0.5, seed=args.seed)
    dev = torch.device("cuda", 0)
    data = tuple(torch.from_numpy(a).to(dev) for a in (x, y, xq))
    del x, y, xq
    say(f"data: n={MAIN['n']} d={MAIN['d']} and {MAIN['n_query']} queries "
        f"from seed {args.seed} in {time.perf_counter() - t0:.2f} s")
    errs = phase_parity(torch, data[0], data[2], args.seed)
    errs["flash_decode"] = phase_parity_decode(torch, dev, args.seed)
    model, counts, _, main_pred = phase_main(torch, data, args.seed)
    phase_small(torch, dev, args.seed)
    dist_state = phase_distributed(torch, data, args.seed, main_pred)
    del main_pred
    lm_counts = phase_lm(torch, dev, args.seed)
    entries = phase_times(torch, data, model, counts, errs, dist_state,
                          lm_counts, args.seed)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
