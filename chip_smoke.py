#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: WLSH-KRR fit,
predict and the distributed step, LM serving, KRR serving, and the paper's
Tables 1 and 2.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout.  Phases, in order; any failure exits
non-zero:

1. Card and build: the card's name and power limit, then the kernels
   built by nvcc for sm_90a from ``src/repro_torch/csrc`` (four sources,
   and a fifth of yardsticks timed in phase 5; one nvcc each, all started
   together).
2. Per-kernel parity at full width (d = m = 64), at n = 2^16 and at the main
   phase's n = 2^22, each kernel against its plain PyTorch version on the
   same inputs: featurize keys, slot and sign bitwise, weight and coeff to
   atol 2e-6; matvec (B2, in its contract form and as the run totals the
   matvec op reads, beta in point order) and blocked scatter to 1e-5 of
   the output's max (both sum in another order than index_add_), each
   also bitwise across two launches, at k = 1 and, where the plain
   version fits, k = 4; gather (B4's contract form) bitwise; the readout
   (B4 with its combine: mean and sum) to 1e-5 of max|out|, bitwise at
   one instance a launch and all in one, on the queries, on the run
   totals read through inv_pos (B = L, the matvec op's shape) and at each
   of phase 8's padding buckets (n = 1 ... 1024).  Then the distributed step's kernels on a
   layout at the split geometry (block_n = 64): the blocked scatter again,
   the point scatter B5 to 1e-5 of max|out| (global atomics), the layout
   gather B6, and the route pack B7 (f32, and bf16 out against the plain
   pack cast to bf16) and unpack B8 bitwise, at k = 1 and 4 for n = 2^16
   over four routings built on the one card (one owner; one owner with
   cap_factor 0.1, which drops buckets; 2 and 4 owners), and again with
   4096 points of every instance on one slot (1 and 2 owners); at
   n = 2^22 one rank's routing and k = 1.  B2 at n = 2^16 on the trap
   layout of ``repro_torch.testing.matvec_model`` (an instance with every
   point on one slot, one with two slots splitting n, runs of a chunk's
   length and one less and one more, a run ending on a chunk's last
   position, zero coefficients), k = 1 and 4, both forms: bitwise the
   numpy model of its sum order, the same bits in two launches, and its
   plain version within phase 9's limit.  B1 also on its edge operands
   (``repro_torch.testing.operands``: NaN, +-inf, |t| at 2^22, 2^23 and
   2^31, ties +- 1 ulp, widths past the fast path's range), all three
   bucket functions, and B1's fast-path quotient bitwise against IEEE
   division on the card for every one of the 2^23 significands of w, each
   at about 5.6 quotients next to a midpoint of two float32s (in [0.5, 2),
   scaled to about 2^20 and to about -2^-30).  Then flash decode
   B9 at the kv-head shapes of gemma3-1b (KV 1, G 4, D 256; f32 and bf16
   caches), qwen3-14b (KV 8, G 5, D 128, bf16), phi3-mini-3.8b (KV 32, G 1,
   D 96, f32) and command-r-plus-104b (KV 8, G 12, D 128, bf16) and one
   long gemma3-1b cache (B 1, T 8191: more splits than a cluster), each
   with random lengths, one valid row, a wrapped ring and no valid row, T
   not a multiple of the tile: 1e-5 of max|out| (f32), 1e-4 (bf16); and at
   phase 7's two shapes (T 512 and 2112) and the long cache, each called
   twice in a row and on two streams.
3. Main phase: ``wlsh_krr_fit`` then ``wlsh_krr_predict`` at the repo's
   ``wlsh_krr`` config (n = 2^22, d = 64, m = 64, B = 2^23, rect,
   Gamma(2, 1), lam = 1, no preconditioner, 32 PCG iterations as the
   config's fixed-iteration step), then 2^20 queries in batches of 2^18.
   Launch counts are reset just before and read just after; a kernel of
   the path (B1, B2, B3, the readout) not launched fails the run.
   Predictions must be finite and match the plain path on the first 4096
   queries.  Predict then runs three times more, warm, outside the
   counts: its first call and the median of the three are printed.
4. Small phase (n = 2^12, k = 4 right-hand sides, jacobi and nystrom at
   rank 128): the fit on the card against the same port on the CPU.
6. Distributed step at the same config on a one-rank NCCL group, through
   ``repro_torch.core.distributed``: (a) the psum step with the split
   matvec off the layout (fused=False: B3 and B6) and ``make_krr_predict``
   on the 2^20 queries, (b) the psum step with the point kernels
   (blocked_split=False: B5 and the readout), (c)
   ``run_krr_step_resilient`` on the bf16 wire and
   ``make_krr_predict_hashjoin`` with and without dedup.  Counts are
   reset before and read after each; a kernel of that path not launched
   fails the run.  Then, outside the counts: the bf16-wire hash-join step
   alone for (c)'s split, and (a)'s beta against the f32-wire
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
   B9's share of a step from its times at the step's two cache shapes, and
   a profiled step, in which B9 must run one device kernel per call.
8. KRR serving of phase 3's model, through ``repro_torch.serve``: export
   with ``include_beta=False`` and 16 golden queries into a temporary
   directory (removed on exit; the disk must have 2.1 GiB free, else the
   run fails), load it onto the card (export and load seconds, the bytes
   on disk, and the host's non-finite scan of the tables are printed).
   Counts reset, then the counted run: a ``Predictor`` (max_batch 1024,
   cache 65536) whose ``warmup`` must capture 11 CUDA graphs (buckets
   1...1024), a request at every bucket's size and of 3, 17, 100, 513,
   1000 and 2500 rows (still 11 graphs after them), the golden block, and
   8192 single-row requests through ``MicroBatcher`` (half repeats,
   max_batch 64, max_wait_us 2000: p50, p99, QPS, batch sizes, cache hit
   rate), submitted as fast as the loop goes, then 2048 more paced at 2000
   QPS; counts read.  A capture records its launches without counting
   them, and each replay counts them (``kernels.captured_launches``); B1
   and the readout must have run from the graphs.  After the run, every
   answer must be bitwise equal to ``wlsh_krr_predict`` on the same rows
   (repeats equal to their first answer) and within 1e-5 of max|pred| of
   the plain path (featurize_ref, readout_ref), the golden block within
   its tol.  (Phase 2 holds B1 and the readout against their plain
   versions at each bucket's shape.)  Per bucket, the warm path
   (pinned copy in, replay, copy out, synchronize), ``predict`` and one
   eager ``wlsh_krr_predict`` with its copies, on the host clock.  Then
   ``ServingRuntime`` over a version root fit at n = 2^16 (a reduced
   scale, so a version writes in seconds): v1 served, v2 poisoned on disk
   and canary-rejected, v3 torn and invisible, v4 swapped in,
   ``rollback()`` to v1; device memory in use falls back to v1's level
   after v2's rejection and after the rollback; v1's answers after it
   against ``wlsh_krr_predict`` (bitwise) and the plain path.  A counted
   run of its own (counts reset before, read after; B1, B2, B3 and the
   readout must launch), listed as ``lifecycle_launches`` in the
   ``kernels`` line apart from ``launches``, whose shapes phase 5 times.
9. The paper's tables at their own sizes, through the port on the card.
   (a) Table 1 (``benchmarks/table1_gp.py`` at scale 1): n_train 3000,
   n_test 1000, d 5 and 30, noise 0.05, lam 0.05; GP data from
   ``core.gp.gp_regression_dataset`` under the sqexp, laplace and
   matern52 covariances (lengthscale max(1, sqrt(d / 6)); an eigh of
   4000 x 4000); exact KRR with each covariance and ``wlsh_krr_fit(mode=
   "exact")`` at m 450 (smooth, Gamma(7, 1) at d 5; rect, Gamma(2, 1) at
   d 30), its lengthscale picked on a validation split over four values.
   Every row is printed and must pass the JAX script's own test; B1, the
   point scatter B5 and the readout must launch (counts reset before,
   read after).  Then, outside the counts, ``build_exact_index`` on one
   d = 5 instance set bitwise against the CPU and ``exact_matvec`` within
   1e-5 of max|out|.  (b) Table 2 (``benchmarks/table2_krr.py``'s grid at
   scale 1: wine 4000 x 11, insurance 5822 x 85, ct_slices 35000 x 384,
   forest 500000 x 54, with its m and D_rff): exact Laplace KRR where its
   peak memory fits the card's free memory (wine, insurance, ct_slices;
   the skip and its reason printed otherwise), RFF, and table-mode WLSH
   (rect, median-heuristic lengthscales from a numpy subsample); RMSE and
   fit seconds; every RMSE must be finite and WLSH's below the mean
   predictor's; B1, B2, B3 and the readout must launch (a counted run of
   its own).  Over (a) and (b), each kernel launch is held against its
   plain version on the same inputs the first time the kernel meets a
   shape (``HeldToPlain``: B1 at phase 2's limits, keys, slot and sign
   bitwise, weight and coeff to 2e-6; B2, B3, B5 and the readout to 1e-5
   of max|out| plus 8 sqrt(n) units of float32 rounding of each output's
   sum of n absolute terms, since Table 1's sums cancel).  The launches of (a) and (b) are added to the
   ``kernels`` line's ``launches`` and listed apart as
   ``tables_launches``; phase 5 times each kernel at its largest shape
   there (``tables_ms``).  (c) The exact estimator at phase 3's points
   (n = 2^22, d = 64, m = 64): ``build_exact_index`` and one
   ``exact_matvec`` timed by CUDA events; phase 5 prints them beside the
   table matvec and B2 on the same points.  Forest's slot-blocked index
   is rebuilt after (b), outside the counts, and its skew printed
   (distinct slots an instance and the points on its largest slot,
   min/median/max over the instances); phase 5 times B2 and the matvec op
   there.
5. Times, run last: B1-B3 and the readout at the main phase's shapes,
   B5-B8 at phase 6's and B9 at the decode_32k shape (T = 32768; the
   gemma3-1b global layer in f32 and bf16, qwen3-14b in bf16), each kernel
   (CUDA events), its plain version, its bound from bytes and operations,
   and one PyTorch library call computing the same function where there
   is one (scaled_dot_product_attention for B9).  B3's bound counts the
   tiles' ranges it reads, not the layout's slack.  B5 and B7 also
   against their first designs (kept for that), B5 split into its kernels
   by torch.profiler, the zero fill of B7's send buffer alone (the
   index_add_ yardstick leaves it out), and B8 against torch.gather
   times coeff (its function in two calls).  The
   readout against its first design (B4's gather kernel, then the PyTorch
   combine; in turns), at one instance a launch and all in one, beside its
   32-byte-sector floor.  B2 as the matvec op runs it (the run totals)
   at phase 3's layout and at forest's (phase 9), each in turns with its
   first design (kept for that; beta laid out beforehand), beside beta
   gathered through src alone; the whole matvec op there in turns with
   the parent's op (beta laid out, B2's first design, the map back, the
   mean), with its peak extra allocation.  B1 beside its SASS
   instruction floor, B9 at
   phase 7's shapes over six turns, and B9 on one long cache (B 1, T
   32768, f32 and bf16) at its plan (splits combined by the last block)
   against the same kernel with its splits capped at a cluster's.  Each
   wrapper also counts its launches by input shape; a kernel's
   ``launches`` are summed over the counted runs (phase 3, phase 6 (a),
   (b) and (c), phase 7, phase 8 with its graphs' replays, phase 9 (a)
   and (b)), and B1, B3, the readout, B7 and B9 are timed at every shape
   the runs before phase 9 launched them at (for B1 and the readout also
   phase 8's eleven bucket shapes, where the kernel's own time comes from
   torch.profiler as ``device_ms``: events over launches back to back
   time the host there), listed with those launches as ``by_shape`` (B9's
   device time from torch.profiler); B1, B2, B3, B5 and the readout also
   at phase 9's largest shape (``tables_ms``).  Last, one replay of each of phase 8's graphs: by
   CUDA events back to back, and its kernels' device time by
   torch.profiler over the warm path's wall (the device-busy share).

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
# phase 2 routings at n = 2^16 (owners, cap_factor): one rank, one that
# drops buckets past capacity, and 2 and 4 owners built on the one card
SMALL_ROUTINGS = ((1, 2.0), (1, 0.1), (2, 2.0), (4, 2.0))
HEAVY = 4096         # points on one slot in phase 2's heavy-bucket input
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
    "bin_readout": ("src/repro_torch/csrc/binning.cu",
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
# the kernels of the main phase (phase 3), each launched there or the run
# fails; bin_gather (B4's contract form, checked in phase 2) runs on no
# path: the readout replaces it there
MAIN_KERNELS = ("featurize", "bin_fused_matvec", "bin_scatter_blocked",
                "bin_readout")
# B9's device kernels (csrc/flash_decode.cu), by name in a profiler trace
B9_KERNELS = ("fma_kernel<", "mma_kernel<")
# phase 7: gemma3-1b at its full config, f32, seeded random weights
LM = dict(arch="gemma3-1b", batch=8, prompt=2048, gen=64)
# B9 parity shapes (name, B, KV, G, D, T, cache dtype): the kv-head shapes of
# four dense archs, T not a multiple of the kernel's 32-row tile
DECODE_PARITY = (("gemma3-1b", 8, 1, 4, 256, 2112, "float32"),
                 ("gemma3-1b", 8, 1, 4, 256, 2111, "float32"),
                 ("gemma3-1b", 8, 1, 4, 256, 2111, "bfloat16"),
                 ("qwen3-14b", 4, 8, 5, 128, 1001, "bfloat16"),
                 ("phi3-mini-3.8b", 4, 32, 1, 96, 517, "float32"),
                 ("command-r-plus-104b", 4, 8, 12, 128, 777, "bfloat16"),
                 # one long cache: more splits than a cluster, combined by
                 # the last block through device memory
                 ("gemma3-1b", 1, 1, 4, 256, 8191, "float32"),
                 ("gemma3-1b", 1, 1, 4, 256, 8191, "bfloat16"))
# B9 at the gemma3-1b serve run's shapes (phase 7: batch 8, the local layers'
# 512-row rings and the global layers' 2112-row caches; splits combined in a
# cluster) and at one long cache (splits combined through device memory by
# the last block, whose arrival counters must reset), each called twice in a
# row and on two streams
DECODE_SERVE = (("gemma3-1b local", 8, 1, 4, 256, 512, "float32"),
                ("gemma3-1b global", 8, 1, 4, 256, 2112, "float32"),
                ("gemma3-1b long", 1, 1, 4, 256, 8191, "float32"))
# B1's edge operands (repro_torch.testing.operands) at full width
EDGE_N = 1 << 16
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


def device_split(torch, fn, reps: int = 20) -> dict[str, float]:
    """Device time of one fn() call by kernel (and memset) name, in ms,
    from torch.profiler over ``reps`` calls: no host time, unlike an event
    pair around launches the host cannot keep up with.  Empty when the
    profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = split.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    return split


def kernel_name(name: str) -> str:
    """A profiler event's kernel name without namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].strip()


def by_shape_entries(tally, timed, fmt):
    """The ``by_shape`` list of one kernel: for each input shape the
    counted run launched it at (``tally``, from its wrapper), those
    launches and the times phase 5 took at that shape (``timed[shape]``, a
    dict); a shape launched but not timed fails the run."""
    missing = [sh for sh in tally if sh not in timed]
    if missing:
        fail(f"launched at shapes phase 5 did not time: {missing}")
    return [dict(shape=fmt(sh), launches=n, **timed[sh])
            for sh, n in sorted(tally.items())]


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


def card_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0])


def sass_fast_path(lib_path, kernel_key):
    """The instructions a thread issues per turn of the innermost loop of
    ``kernel_key`` in a built library, walked from the loop head along the
    path where no predicated branch is taken (B1's fast path): (the loop's
    static length, the path's length, counts by opcode); None when cuobjdump
    is missing."""
    import collections
    import re
    from repro_torch.kernels._build import _nvcc
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", sass)
                 if kernel_key in f.split("\n")[0]), None)
    if body is None:
        return None
    ins = [(int(a, 16), t.strip()) for a, t in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s*([^;]*);", body)]
    where = {a: i for i, (a, _) in enumerate(ins)}

    def target(t):
        hit = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", t)
        return int(hit.group(1), 16) if hit else None

    loops = [(a, target(t)) for a, t in ins
             if target(t) is not None and target(t) < a]
    inner = [(a, h) for a, h in loops
             if not any(o != (a, h) and h <= o[1] and o[0] <= a
                        for o in loops)]
    end, head = max(inner, key=lambda lp: lp[0] - lp[1])
    i, path = where[head], []
    while True:
        a, t = ins[i]
        path.append(t)
        if a == end:
            break
        tg = target(t)
        if tg is not None and tg > a and not t.startswith("@"):
            i = where[tg]
        else:
            i += 1
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                              for t in path)
    return (end - head) // 16 + 1, len(path), ops


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


def compare_featurize(torch, got, want, what):
    """B1's outputs against featurize_ref's: keys, slot and sign bitwise,
    weight and coeff to atol 2e-6.  Returns the weight/coeff error."""
    torch.cuda.synchronize()
    for name, g, w in zip(("key1", "key2", "slot", "sign"),
                          (got[0], got[1], got[4], got[3]),
                          (want[0], want[1], want[4], want[3])):
        if not torch.equal(g, w):
            fail(f"featurize {what}: {name} differs in "
                 f"{int((g != w).sum())} places")
    err = max(max_err(got[2], want[2]), max_err(got[5], want[5]))
    if err > 2e-6:
        fail(f"featurize {what}: weight/coeff err {err}")
    return err


def check_featurize(torch, x, lsh, f, table_size):
    from repro_torch.kernels.featurize import featurize_cuda, featurize_ref
    got = featurize_cuda(x, *lsh, f=f, table_size=table_size)
    want = featurize_ref(x, *lsh, f=f, table_size=table_size)
    return got, compare_featurize(torch, got, want,
                                  f"{f.name} n={x.shape[0]}")


def check_binning(torch, lay, beta, k):
    """Fused matvec (both output forms, beta in point order) and blocked
    scatter on ``lay`` against their plain versions, each also bitwise
    across two launches; beta (n,) or (n, k).  Returns (matvec err,
    scatter err, scatter's tables, the matvec's run totals)."""
    from repro_torch.kernels.binning import (bin_fused_matvec_cuda,
                                             bin_scatter_blocked_cuda,
                                             fused_matvec_ref,
                                             fused_matvec_src_ref,
                                             scatter_blocked_ref)
    from repro_torch.kernels.binning.ops import _beta_to_layout
    width = lay.num_tiles * lay.block_t
    beta_lay = _beta_to_layout(lay, beta)
    e_mv = 0.0
    for totals in (False, True):
        run = lambda: bin_fused_matvec_cuda(lay.slot_lay, lay.coeff_lay,
                                            lay.src, beta, totals=totals)
        got = run()
        if not torch.equal(got.view(torch.int32), run().view(torch.int32)):
            fail(f"fused matvec k={k} totals={totals}: two launches differ")
        want = (fused_matvec_src_ref(lay.slot_lay, lay.coeff_lay, lay.src,
                                     beta, totals=True) if totals else
                fused_matvec_ref(lay.slot_lay, lay.coeff_lay, beta_lay,
                                 width=width))
        err = max_err(got, want)
        lim = 1e-5 * float(want.abs().max())
        del want
        if err > lim:
            fail(f"fused matvec k={k} totals={totals}: err {err} > {lim}")
        e_mv = max(e_mv, err)
    coeff = lay.coeff_lay if beta.ndim == 1 else lay.coeff_lay[:, None, :]
    contrib = coeff * beta_lay
    run = lambda: bin_scatter_blocked_cuda(lay.blk_start, lay.slot_lay,
                                           contrib, block_n=lay.block_n,
                                           block_t=lay.block_t)
    tables = run()
    if not torch.equal(tables, run()):
        fail(f"blocked scatter k={k}: two launches differ")
    want = scatter_blocked_ref(lay.slot_lay, contrib, width=width)
    e_sc = max_err(tables, want)
    lim = 1e-5 * float(want.abs().max())
    if e_sc > lim:
        fail(f"blocked scatter k={k}: err {e_sc} > {lim}")
    return e_mv, e_sc, tables, got


def check_matvec_model(torch, slot, coeff, table_size, k, what):
    """B2 on the layout of (slot, coeff), both output forms, bit for bit
    the numpy model of its sum order (repro_torch.testing.matvec_model),
    the same bits in two launches, and its plain version within phase 9's
    limit for kernels that sum (``plain_err``: one run holds all n points
    here); float beta (n,) or (n, k).  Returns the largest share of that
    limit."""
    from repro_torch.core.wlsh import build_blocked_layout
    from repro_torch.kernels.binning import bin_fused_matvec_cuda
    from repro_torch.testing.matvec_model import fused_matvec_model
    lay = build_blocked_layout(slot, coeff, table_size)
    n = slot.shape[1]
    beta = torch.randn((n,) if k == 1 else (n, k), device=slot.device)
    host = [t.cpu() for t in (lay.slot_lay, lay.coeff_lay, lay.src)]
    worst = 0.0
    for totals in (False, True):
        run = lambda: bin_fused_matvec_cuda(lay.slot_lay, lay.coeff_lay,
                                            lay.src, beta, totals=totals)
        got = run().view(torch.int32)
        if not torch.equal(got, run().view(torch.int32)):
            fail(f"fused matvec {what} k={k}: two launches differ")
        model = fused_matvec_model(*host, beta.cpu().numpy(), totals=totals)
        off = int((got.cpu().numpy() != model.view(np.int32)).sum())
        if off:
            fail(f"fused matvec {what} k={k} totals={totals}: not bitwise "
                 f"the model in {off} places")
        res = plain_err(torch, "bin_fused_matvec", dict(
            slot_lay=lay.slot_lay, coeff_lay=lay.coeff_lay, src=lay.src,
            beta=beta, totals=totals), got.view(torch.float32),
            f"{what} k={k} totals={totals}")
        worst = max(worst, res["share"])
    return worst


def check_gather(torch, slot, tables):
    from repro_torch.kernels.binning import bin_gather_cuda, gather_ref
    got = bin_gather_cuda(slot, tables)
    if not torch.equal(got, gather_ref(slot, tables)):
        fail(f"gather {tuple(tables.shape)}: not bitwise equal")


def check_readout(torch, slot, coeff, tables):
    """The readout (mean and sum) against its plain version, to 1e-5 of
    max|out|, and bitwise at one instance a launch and all in one.
    Returns the larger error."""
    from repro_torch.kernels.binning import bin_readout_cuda, readout_ref
    from repro_torch.kernels.binning.kernel import _readout_launch
    worst = 0.0
    for average in (True, False):
        got = bin_readout_cuda(slot, coeff, tables, average=average)
        want = readout_ref(slot, coeff, tables, average)
        err = max_err(got, want)
        lim = 1e-5 * float(want.abs().max())
        if not err <= lim:
            fail(f"readout {tuple(tables.shape)} average={average}: err "
                 f"{err} > {lim}")
        for group in (1, slot.shape[0]):
            if not torch.equal(got, _readout_launch(slot, coeff, tables,
                                                    average, group)):
                fail(f"readout {tuple(tables.shape)}: {group} instance(s) "
                     f"a launch differs from the default")
        worst = max(worst, err)
    return worst


def check_buckets(torch, xq, lsh, tables):
    """B1 and the readout at every padding bucket of phase 8 (queries
    n = 1 ... max_batch, the kernels' small-n plans and the readout's tail
    case), each against its plain version as ``check_featurize`` and
    ``check_readout`` hold it.  Returns (featurize err, readout err)."""
    import repro_torch.core as T
    from repro_torch.serve import bucket_sizes
    e_f = e_ro = 0.0
    for b in bucket_sizes(SERVE["max_batch"]):
        feats, e = check_featurize(torch, xq[:b], lsh, T.RECT,
                                   tables.shape[1])
        e_f = max(e_f, e)
        e_ro = max(e_ro, check_readout(torch, feats[4], feats[5], tables))
    return e_f, e_ro


def plain_predict(torch, model, rows):
    """The plain path on ``rows`` (numpy): featurize_ref, then the
    readout's plain mean (readout_ref), on the model's device."""
    import repro_torch.core as T
    from repro_torch.kernels.binning import readout_ref
    from repro_torch.kernels.featurize import featurize_ref
    x = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
        model.tables.device)
    f = featurize_ref(x, *model.lsh, f=T.get_bucket_fn(model.bucket_name),
                      table_size=model.table_size)
    return readout_ref(f[4], f[5], model.tables, True).cpu().numpy()


def check_plain(what, got, want):
    """Served predictions against the plain path's, to 1e-5 of
    max|plain|; returns the error."""
    err = float(np.abs(got.astype(np.float64) - want).max())
    lim = 1e-5 * float(np.abs(want).max())
    if not err <= lim:
        fail(f"phase 8: {what} differs from the plain path by {err} > {lim}")
    return err


def split_setup(torch, slot, coeff, table_size, routings=((1, 2.0),)):
    """The distributed step's arrays on the one card: a layout at the split
    geometry (both groups, then the sorted-segment group dropped once the
    routings have used it) and, for each (owners, cap_factor) in
    ``routings``, the hash join's wire cells, ``used`` and cap, built for
    that many owners from this card's points."""
    from repro_torch.core import distributed as D
    from repro_torch.core.wlsh import BLOCKED_SPLIT_N, build_blocked_layout
    lay = build_blocked_layout(slot, coeff, table_size,
                               block_n=BLOCKED_SPLIT_N, parts="both")
    routes = []
    for n_shards, cap_factor in routings:
        pt_cell, _, _, cap, dropped, _, used = D._routing_maps(
            slot, lay, n_shards, table_size, cap_factor)
        routes.append(dict(n_shards=n_shards, cap_factor=cap_factor,
                           cell_lay=D._make_route_plan(pt_cell, lay,
                                                       n_shards * cap),
                           used=used, cap=cap, dropped=int(dropped)))
        del pt_cell
    lay = lay._replace(perm=None, seg_id=None, seg_pt=None,
                       coeff_sorted=None)
    return lay, routes


def check_dist_kernels(torch, slot, coeff, lay, routes, beta, table_size):
    """B5 (to 1e-5 of max|out|), B6 (bitwise) and, for every routing, B7 in
    f32 and bf16 and B8 (bitwise) against their plain versions on the same
    inputs; beta (n,) or (n, k).  Returns B5's max error."""
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
    for rt in routes:
        cell_lay, used, cap = rt["cell_lay"], rt["used"], rt["cap"]
        nb = rt["n_shards"] * cap
        what = f"k={k}, {rt['n_shards']} owner(s), cap_factor " \
            f"{rt['cap_factor']}"
        send = route_pack_ref(cell_lay, contrib_lay, num_cells=nb)
        if not torch.equal(route_pack_cuda(cell_lay, contrib_lay, used, cap),
                           send):
            fail(f"route pack {what}: not bitwise equal")
        got16 = route_pack_cuda(cell_lay, contrib_lay, used, cap,
                                out_dtype=torch.bfloat16)
        if not torch.equal(got16.view(torch.int16),
                           send.to(torch.bfloat16).view(torch.int16)):
            fail(f"route pack {what}, bf16 out: not bitwise equal to the "
                 f"plain pack cast to bf16")
        del got16
        if not torch.equal(route_unpack_cuda(cell_lay, lay.coeff_lay, send),
                           route_unpack_ref(cell_lay, lay.coeff_lay, send)):
            fail(f"route unpack {what}: not bitwise equal")
        del send
    return e5


def check_featurize_edges(torch, dev, seed):
    """B1 on its edge operands (where the fast divide and rounding hand
    over to the exact path, and ties) for all three bucket functions."""
    import repro_torch.core as T
    from repro_torch.core.lsh import lsh_params_from_numpy
    from repro_torch.testing.operands import featurize_edge_case
    x, w, z, r1, r2 = featurize_edge_case(seed, EDGE_N, MAIN["d"], MAIN["m"])
    xt = torch.from_numpy(x).to(dev)
    lsh = lsh_params_from_numpy(w, z, r1, r2, dev)
    for fname in ("rect", "tent", "smooth"):
        _, err = check_featurize(torch, xt, lsh, T.get_bucket_fn(fname),
                                 MAIN["table_size"])
        say(f"  featurize[{fname}] on the edge operands (n={EDGE_N}: NaN, "
            f"+-inf, subnormal, |t| at 2^22 / 2^23 / 2^31, k + 1/2 +- 1 ulp; "
            f"w at 2^-60 / 2^60 and past them, near FLT_MIN and FLT_MAX): "
            f"keys/slot/sign bitwise, weight/coeff max err {err:.3g}")


def check_featurize_quotient(torch, dev):
    """B1's fast-path quotient (the kernel's device function, run alone)
    bitwise against IEEE division (torch's on the card, and numpy's on a
    sample) at quotients next to a midpoint of two float32s, for every
    significand of w."""
    from repro_torch.kernels.featurize.kernel import fast_quotient_cuda
    from repro_torch.testing.operands import tie_adjacent_quotients
    t0 = time.perf_counter()
    a, w = tie_adjacent_quotients(torch.arange(1 << 23, 1 << 24,
                                               device=dev))
    total = 0
    for scale in (1.0, 2.0 ** 20, -(2.0 ** -30)):
        sa = a * scale
        got, want = fast_quotient_cuda(sa, w), sa / w
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            i = int((got != want).nonzero()[0])
            fail(f"featurize quotient differs from IEEE division at "
                 f"a={float(sa[i])!r}, w={float(w[i])!r}: "
                 f"{float(got[i])!r} against {float(want[i])!r}")
        pick = torch.randperm(sa.numel(), device=dev)[:1 << 20]
        an, wn = sa[pick].cpu().numpy(), w[pick].cpu().numpy()
        if not np.array_equal(got[pick].cpu().numpy(), an / wn):
            fail(f"featurize quotient differs from numpy's division on a "
                 f"sample (scale {scale})")
        total += sa.numel()
    say(f"  featurize quotient at tie-adjacent a / w, every significand of "
        f"w (2^23), {total} operands over 3 scales: bitwise equal to IEEE "
        f"division ({time.perf_counter() - t0:.2f} s)")


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
        if n != MAIN["n"]:
            check_featurize_edges(torch, x.device, seed)
            check_featurize_quotient(torch, x.device)
        slot, coeff = feats[4], feats[5]
        del feats
        lay = build_blocked_layout(slot, coeff, table_size)
        beta = torch.randn(n, device=x.device)
        e_mv, e_sc, tables, totals = check_binning(torch, lay, beta, 1)
        say(f"  n={n} k=1 fused matvec err {e_mv:.3g} (contract form and "
            f"run totals), blocked scatter err {e_sc:.3g} (limit 1e-5 of "
            f"max|out|), each bitwise across two launches")
        # the readout as the fused matvec op runs it: the run totals read
        # through inv_pos (B = L)
        e_rl = check_readout(torch, lay.inv_pos, coeff, totals)
        del totals
        say(f"  n={n} readout of the run totals over inv_pos (B = L = "
            f"{lay.slot_lay.shape[1]}): err {e_rl:.3g} (mean and sum), "
            f"bitwise at 1 and {MAIN['m']} instances a launch")
        qf = featurize_cuda(xq[:MAIN["batch"]], *lsh, f=T.RECT,
                            table_size=table_size)
        q_slot, q_coeff = qf[4], qf[5]
        del qf
        t1 = tables[:, :table_size].contiguous()
        del tables
        check_gather(torch, q_slot, t1)
        e_ro = check_readout(torch, q_slot, q_coeff, t1)
        say(f"  n={n} gather (m, B) bitwise over {q_slot.shape[1]} queries; "
            f"readout err {e_ro:.3g} (mean and sum; limit 1e-5 of max|out|),"
            f" bitwise at 1 and {MAIN['m']} instances a launch")
        e_fb, e_rb = check_buckets(torch, xq, lsh, t1)
        say(f"  n={n} at phase 8's padding buckets (1 ... "
            f"{SERVE['max_batch']} queries): featurize keys/slot/sign "
            f"bitwise, weight/coeff err {e_fb:.3g}; readout err {e_rb:.3g} "
            f"(mean and sum), bitwise at 1 and {MAIN['m']} instances a "
            f"launch")
        if n == MAIN["n"]:
            errs.update(featurize=max(e_f, e_fb), bin_fused_matvec=e_mv,
                        bin_scatter_blocked=e_sc,
                        bin_readout=max(e_ro, e_rb, e_rl))
        del t1
        if n != MAIN["n"]:
            beta4 = torch.randn(n, 4, device=x.device)
            e_mv, e_sc, tables4, _ = check_binning(torch, lay, beta4, 4)
            say(f"  n={n} k=4 fused matvec err {e_mv:.3g}, blocked "
                f"scatter err {e_sc:.3g}")
            t4 = tables4[..., :table_size].transpose(1, 2).contiguous()
            check_gather(torch, q_slot, t4)
            e_ro = check_readout(torch, q_slot, q_coeff, t4)
            say(f"  n={n} gather (m, B, 4) bitwise; readout err {e_ro:.3g}")
            del tables4, t4
        else:
            say(f"  n={n} k=4: not compared (the plain version's int64 "
                f"index and (m, k, L) temporaries need about 55 GB)")
        del lay
        full = n == MAIN["n"]
        lay, routes = split_setup(torch, slot, coeff, table_size,
                                  ((1, 2.0),) if full else SMALL_ROUTINGS)
        say(f"  n={n} routings (owners, cap_factor: wire cells, dropped "
            f"buckets): " + "; ".join(
                f"{r['n_shards']}, {r['cap_factor']}: "
                f"{r['n_shards'] * r['cap']}, {r['dropped']}"
                for r in routes))
        for k in ((1,) if full else (1, 4)):
            b = beta if k == 1 else torch.randn(n, k, device=x.device)
            e_mv, e_sc, _, _ = check_binning(torch, lay, b, k)
            e5 = check_dist_kernels(torch, slot, coeff, lay, routes, b,
                                    table_size)
            say(f"  n={n} k={k} split geometry (block_n={lay.block_n}): "
                f"fused matvec err {e_mv:.3g}, blocked scatter err "
                f"{e_sc:.3g}, point scatter err {e5:.3g} (limit 1e-5 of "
                f"max|out|); layout gather, route pack (f32 and bf16 out, "
                f"every routing), route unpack bitwise")
            if full:
                errs.update(bin_scatter=e5, bin_gather_blocked=0.0,
                            route_pack=0.0, route_unpack=0.0)
        del lay, routes
        if not full:
            # a heavy bucket: HEAVY points of every instance on one slot
            heavy = slot.clone()
            heavy[:, :HEAVY] = table_size // 3
            lay, routes = split_setup(torch, heavy, coeff, table_size,
                                      ((1, 2.0), (2, 2.0)))
            for k in (1, 4):
                b = beta if k == 1 else torch.randn(n, k, device=x.device)
                e5 = check_dist_kernels(torch, heavy, coeff, lay, routes, b,
                                        table_size)
                say(f"  n={n} k={k} {HEAVY} points per instance on one "
                    f"slot: point scatter err {e5:.3g}; route pack (1 and "
                    f"2 owners, f32 and bf16 out) and unpack bitwise")
            del lay, routes, heavy
            # B2 on the trap layout: one slot holding every point, two
            # slots splitting n, runs of a chunk's length and one less and
            # one more, a run ending on a chunk's last position, zero
            # coefficients; then the random instances
            from repro_torch.testing.matvec_model import (TRAPS,
                                                          trap_layout)
            t_slot, t_coeff = trap_layout(np.random.default_rng(seed + 5),
                                          m=MAIN["m"], n=n,
                                          table_size=table_size,
                                          device=x.device)
            for k in (1, 4):
                e2 = check_matvec_model(torch, t_slot, t_coeff, table_size,
                                        k, "trap layout")
                say(f"  n={n} k={k} fused matvec on the trap layout "
                    f"({', '.join(TRAPS)}, then random): both forms "
                    f"bitwise the numpy model and across two launches; "
                    f"{e2:.3g} of phase 9's limit against the plain "
                    f"version")
            del t_slot, t_coeff
        del slot, coeff
        torch.cuda.empty_cache()
    return errs


def phase_main(torch, data, seed):
    import repro_torch.core as T
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
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
    shapes = launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated()
    # predict again, warm, outside the counts: the median of three calls
    warm = []
    for _ in range(3):
        t3 = sync_clock(torch)
        again = T.wlsh_krr_predict(model, xq, batch_size=MAIN["batch"])
        warm.append(sync_clock(torch) - t3)
        if not torch.equal(again, pred):
            fail("predict: a warm call differs from the first")
    del again
    tel = model.telemetry
    phases = dict(tel["phase_seconds"], predict=t2 - t1,
                  predict_warm=sorted(warm)[1])
    say("  wall s (synchronized): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items())
        + f"; fit total {t1 - t0:.4f}; predict's first call, then the "
        f"median of three warm calls ("
        + ", ".join(f"{w:.4f}" for w in warm) + ")")
    hist = tel["resnorm_history"][:, 0]
    bnorm = float(torch.linalg.vector_norm(y))
    say(f"  PCG iterations {tel['iters']}, resnorm {hist[0]:.4g} -> "
        f"{hist[-1]:.4g} (relative {hist[-1] / bnorm:.3g})")
    say(f"  peak device memory {peak / 2**30:.2f} GiB")
    say(f"  launches {counts}; featurize by (n, d, m): "
        f"{shapes['featurize']}")
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
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
    return model, (counts, shapes), phases, pred


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
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
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
    counts, shapes, report = {}, {}, {}

    def run(path, label, fn, need=()):
        """One step, synchronised; counts reset before and read after when
        ``need`` names the kernels this path must launch."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = sync_clock(torch)
        out = fn()
        wall = sync_clock(torch) - t0
        c, sh = launch_counts(), launch_counts_by_shape()
        peak = torch.cuda.max_memory_allocated()
        ran = {k: v for k, v in c.items() if v}
        say(f"  ({path}) {label}: wall {wall:.4f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB, launches {ran}")
        missing = [k for k in need if c[k] <= 0]
        if missing:
            fail(f"phase 6 ({path}): kernels not launched: {missing}")
        if need:
            counts[path], shapes[path] = c, sh
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

    # (b) psum with the point kernels: B5, B4 (the readout)
    step_b = D.make_krr_step(mesh, D.KRRStepConfig(
        **base, fused=False, blocked_split=False), T.RECT)
    beta_b, res_b, _ = run("b", "psum step blocked_split=False",
                           lambda: step_b(x, y, lsh),
                           ("featurize", "bin_scatter", "bin_readout"))
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
    say(f"      route_pack by (m, L, k, cells, out dtype): "
        f"{shapes['c']['route_pack']}")
    say(f"      resnorm {float(res_c):.4g}; StepStats overflow_dropped "
        f"{int(stats_c.overflow_dropped)}, wire_nonfinite "
        f"{int(stats_c.wire_nonfinite)}")

    # comparisons, outside the counted paths; (c)'s step split from the
    # same step on its own
    step_c = D.make_krr_step_hashjoin(mesh, cfg_c, T.RECT,
                                      payload_dtype=torch.bfloat16)
    run("hj-bf16", "hash-join step (bf16 wire, as in (c))",
        lambda: step_c(x, y, lsh))
    say(f"      step split ms: {split(step_c)}")
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
    return lsh, beta_a, counts, shapes


def dist_times(torch, x, lsh, beta, ts):
    """B5-B8 at phase 6's shapes (n = 2^22, one rank's routing), with
    their plain versions and library calls; B5 and B7 also against their
    first designs, B5 split by the profiler into its kernels, B7's zero
    fill of the send buffer alone, B8 against torch.gather times coeff (two
    calls: B8's function), and B3 at path (a)'s split layout.  Returns the
    rows, B7's times by its wrapper's shape key (f32 and bf16 out), B3's
    at the split layout and the extra keys of B8's entry."""
    import repro_torch.core as T
    from repro_torch.kernels.binning import (bin_gather_blocked_cuda,
                                             bin_scatter_cuda,
                                             gather_blocked_ref,
                                             route_pack_cuda, route_pack_ref,
                                             route_unpack_cuda,
                                             route_unpack_ref, scatter_ref)
    from repro_torch.kernels.binning.variants import (bin_scatter_v1_cuda,
                                                      route_pack_v1_cuda)
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
    v1 = time_ms(torch, lambda: bin_scatter_v1_cuda(slot, contrib, ts))
    plain = time_ms(torch, lambda: scatter_ref(slot, contrib, table_size=ts),
                    reps=1, warmup=False)
    flat = (slot.long() + ts * torch.arange(m, device=x.device)[:, None]
            ).view(-1)
    acc = torch.zeros(m * ts, device=x.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, flat, contrib.view(-1)))
    rows["bin_scatter"] = (ms, plain, bound(nbytes(slot, contrib, tables),
                                            contrib.numel()), lib)
    say(f"  B5 point scatter: partitioned into shared tiles {ms:.4f} ms, "
        f"first design (memset + global atomics) {v1:.4f} ms")
    say("    device split (torch.profiler): " + ", ".join(
        f"{kernel_name(name)} {t:.4f} ms"
        for name, t in device_split(torch, run).items()))
    del flat, acc, contrib
    torch.cuda.empty_cache()

    lay, routes = split_setup(torch, slot, coeff, ts)
    cell_lay, used, cap = (routes[0][key] for key in ("cell_lay", "used",
                                                      "cap"))
    nb = cap
    del slot, coeff, routes
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
        f"(instance, slot) buckets, {nb} wire cells, {int(used.sum())} "
        f"of them reached")
    del out, idx, tables
    torch.cuda.empty_cache()

    contrib_lay = lay.coeff_lay * layout_rows(lay, beta)
    run = lambda: route_pack_cuda(cell_lay, contrib_lay, used, cap)
    send = run()
    ms = time_ms(torch, run)
    ms16 = time_ms(torch, lambda: route_pack_cuda(
        cell_lay, contrib_lay, used, cap, out_dtype=torch.bfloat16))
    v1 = time_ms(torch, lambda: route_pack_v1_cuda(cell_lay, contrib_lay,
                                                   nb))
    v1_cast = time_ms(torch, lambda: route_pack_v1_cuda(
        cell_lay, contrib_lay, nb).to(torch.bfloat16))
    plain = time_ms(torch, lambda: route_pack_ref(cell_lay, contrib_lay,
                                                  num_cells=nb),
                    reps=1, warmup=False)
    # the library call adds the real positions only (sentinels sent to one
    # spare cell would all add to one address), into a buffer it never
    # zeroes again: the zero fill is timed on its own
    real = (cell_lay < nb).view(-1).nonzero()[:, 0]
    cells, vals = cell_lay.view(-1)[real].long(), contrib_lay.view(-1)[real]
    del real
    acc = torch.zeros(nb, device=x.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, cells, vals))
    fill = time_ms(torch, lambda: acc.zero_())
    rows["route_pack"] = (ms, plain, bound(nbytes(cell_lay, contrib_lay,
                                                  send),
                                           contrib_lay.numel()), lib)
    b16, _ = bound(nbytes(cell_lay, contrib_lay) + 2 * send.numel(),
                   contrib_lay.numel())
    key = tuple(cell_lay.shape) + (1, nb)
    pack_timed = {key + ("float32",): dict(ms=ms,
                                           bound_ms=rows["route_pack"][2][0]),
                  key + ("bfloat16",): dict(ms=ms16, bound_ms=b16)}
    say(f"  B7 route pack: one pass {ms:.4f} ms f32, {ms16:.4f} ms bf16 out "
        f"(bound {b16:.4f} ms); first design (memset + run-head walks) "
        f"{v1:.4f} ms f32, {v1_cast:.4f} ms with the bf16 cast after it; "
        f"index_add_ {lib:.4f} ms on the real positions, plus the zero fill "
        f"of the send buffer it leaves out, {fill:.4f} ms")
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
    # B8's function in PyTorch: the gather (the sentinel reads the zero
    # past the cells) times coeff, two calls
    with_coeff = time_ms(torch, lambda: torch.gather(
        back.expand(m, -1), 1, idx) * lay.coeff_lay)
    rows["route_unpack"] = (ms, plain, bound(
        nbytes(cell_lay, lay.coeff_lay, out) + 4 * distinct,
        out.numel()), lib)
    say(f"  B8 route unpack {ms:.4f} ms; torch.gather alone {lib:.4f} ms, "
        f"torch.gather times coeff (B8's function, two calls) "
        f"{with_coeff:.4f} ms")
    say("  (library calls: index_add_ for B5 and B7, torch.gather for B6 "
        "and B8 -- B8's without the coeff product)")
    del out, idx, back, send, cell_lay
    torch.cuda.empty_cache()
    # B3 last, so B5-B8 are timed as before it was added here
    _, b3 = b3_times(torch, lay, lay.coeff_lay * layout_rows(lay, beta),
                     "at path (a)'s split layout")
    b3_split = {tuple(lay.slot_lay.shape) + (1,): b3}
    return rows, pack_timed, b3_split, {
        "route_unpack": dict(gather_coeff_ms=with_coeff)}


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
    for i, (arch, b, kv, g, d, t, dt) in enumerate(DECODE_SERVE):
        errs = []
        for lens in ("random", "one", "wrapped", "none"):
            args = decode_inputs(torch, dev, b, kv, g, d, t,
                                 getattr(torch, dt), seed + 100 + i, lens)
            want = flash_decode_ref(*args)
            lim = 1e-5 * float(want.abs().max())
            outs = [flash_decode_cuda(*args), flash_decode_cuda(*args)]
            torch.cuda.synchronize()
            streams = (torch.cuda.Stream(), torch.cuda.Stream())
            for st in streams:
                st.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(st):
                    outs.append(flash_decode_cuda(*args))
            torch.cuda.synchronize()
            for j, got in enumerate(outs):
                err = max_err(got, want)
                if not (bool(torch.isfinite(got).all()) and err <= lim):
                    fail(f"flash decode {arch} serve T={t} {lens}, call "
                         f"{j + 1} of 4 (2 in a row, then 2 streams): err "
                         f"{err} > {lim}")
                errs.append(err)
        worst = max(worst, max(errs))
        say(f"  {arch} B={b} KV={kv} G={g} D={d} T={t} {dt}: max err "
            f"{max(errs):.3g} over the four masks, each called twice in a "
            f"row and on two streams (limit 1e-5 of max|out|)")
    return worst


def phase_lm(torch, dev, seed):
    """Phase 7: gemma3-1b at its full config served through
    repro_torch.launch.serve.generate, then prefill/decode consistency."""
    from repro_torch.configs import registry
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
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
    counts, shapes = launch_counts(), launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = n_gen - 1
    per_step = t_dec / steps * 1e3
    say(f"  prefill {b}x{s}: {t_pre * 1e3:.2f} ms; decode {steps} steps: "
        f"{per_step:.3f} ms per step, {b * steps / t_dec:.1f} tok/s; peak "
        f"device memory {peak:.2f} GiB")
    say(f"  launches {dict((k, v) for k, v in counts.items() if v)}; "
        f"flash_decode by (B, T, KV, G, D, cache dtype): "
        f"{shapes['flash_decode']}")
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
    return counts, shapes


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
    b9 = {kernel_name(name): (n, us) for name, (n, us) in by_name.items()
          if kernel_name(name).startswith(B9_KERNELS)}
    b9_n = sum(n for n, _ in b9.values()) / steps
    say(f"    B9 on the device: {b9_n:.0f} kernels a step, one a call "
        f"({', '.join(b9)}), {sum(us for _, us in b9.values()) / 1e3 / steps:.3f}"
        f" ms/step")
    if b9_n != cfg.n_layers:
        fail(f"phase 7: {b9_n} B9 kernels a decode step on the device, not "
             f"one per layer ({cfg.n_layers})")
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


def device_ms(torch, fn):
    """Device time of one fn() call, summed over its kernels (profiler), or
    None when the profiler records no device event."""
    split = device_split(torch, fn)
    return sum(split.values()) if split else None


def turns(torch, fns: dict, rounds: int = 3) -> dict:
    """Device times of each fn in ``fns`` (name -> fn) in alternating turns:
    the names in order, then in reverse, ``rounds`` times.  {name: [ms of
    each turn]}; a turn the profiler saw nothing of is left out."""
    out = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order + order[::-1]:
            ms = device_ms(torch, fns[name])
            if ms is not None:
                out[name].append(ms)
    return out


def spread(ts) -> str:
    return (f"{sum(ts) / len(ts):.4f} ms (min {min(ts):.4f}, max "
            f"{max(ts):.4f}, {len(ts)} turns)" if ts else "not measured")


def decode_serve_times(torch, dev, seed, tally):
    """B9 at every shape phase 7 launched it at (``tally``: its launches by
    (B, T, KV, G, D, cache dtype); gemma3-1b: the global layers' caches
    and the local layers' rings): device time from the profiler over
    several turns against the bound, on a wrapped ring (every row
    valid)."""
    from repro_torch.kernels.flash_decode import flash_decode_cuda
    timed = {}
    for key in tally:
        b, t, kv, g, d, dt = key
        q, k, v, valid = decode_inputs(torch, dev, b, kv, g, d, t,
                                       getattr(torch, dt), seed,
                                       lens="wrapped")
        out = flash_decode_cuda(q, k, v, valid)
        run = lambda: flash_decode_cuda(q, k, v, valid)
        names = [kernel_name(n) for n in device_split(torch, run)]
        got = turns(torch, {"new": run})
        b_ms, _ = bound(nbytes(q, k, v, valid, out), 4.0 * q.numel() * t)
        mean = lambda ts: sum(ts) / len(ts) if ts else None
        timed[key] = dict(device_ms=mean(got["new"]), bound_ms=b_ms)
        say(f"  B9 at phase 7's B={b} KV={kv} G={g} D={d} T={t} {dt}: "
            f"device {spread(got['new'])} (torch.profiler: "
            + ", ".join(names) + f"), bound {b_ms:.4f} ms, {tally[key]} "
            f"launches in phase 7; turns "
            + " ".join(f"{x:.4f}" for x in got["new"]))
        del q, k, v, valid, out
    return timed


def decode_long_times(torch, dev, seed):
    """B9 on one long cache (gemma3-1b global, B 1, T 32768, every row
    valid; f32 and bf16), where its plan has more splits than a cluster and
    the last block combines them: device time at that plan and at the same
    kernel's splits capped at a cluster's (combined in the cluster), in
    alternating turns."""
    from repro_torch.kernels.flash_decode import kernel
    b, kv, g, d, t = 1, 1, 4, 256, 32768
    for i, dt in enumerate(("float32", "bfloat16")):
        q, k, v, valid = decode_inputs(torch, dev, b, kv, g, d, t,
                                       getattr(torch, dt), seed + i,
                                       lens="wrapped")
        rows, slots = kernel.kernel_geometry(dev, g, d, dt == "bfloat16")
        plan = kernel.split_plan(b, kv, t, slots, rows)
        capped = kernel.split_plan(b, kv, t, kernel.MAX_CLUSTER * b * kv,
                                   rows)
        fns = {"plan": lambda: kernel._launch(q, k, v, valid, 0.0, *plan),
               "capped": lambda: kernel._launch(q, k, v, valid, 0.0,
                                                *capped)}
        want = fns["capped"]()
        err = max_err(fns["plan"](), want) / float(want.abs().max())
        if err > (1e-5 if dt == "float32" else 1e-4):
            fail(f"B9 long cache {dt}: plan and capped plan differ by "
                 f"{err:.3g} of max|out|")
        got = turns(torch, fns)
        b_ms, _ = bound(nbytes(q, k, v, valid, want), 4.0 * q.numel() * t)
        say(f"  B9 long cache B={b} KV={kv} G={g} D={d} T={t} {dt}: plan "
            f"{plan[0]} splits of {plan[1]} rows ("
            + ("last-block" if plan[0] > kernel.MAX_CLUSTER else "cluster")
            + f" combine) {spread(got['plan'])}; capped at {capped[0]} "
            f"splits of {capped[1]} rows (cluster combine) "
            f"{spread(got['capped'])}; bound {b_ms:.4f} ms; plans agree to "
            f"{err:.2g} of max|out|")
        del q, k, v, valid, want
        torch.cuda.empty_cache()


_B1_WALKS = {}


def b1_floor(torch, m, n, d):
    """B1's SASS instruction floor at (m, n, d): the instructions a thread
    issues per element on the fast path of the rect kernel the launcher
    takes for d (from cuobjdump of the built library), times m n d, over
    the SMs' issue rate (4 warp instructions a clock at the maximum SM
    clock).  (floor ms, per element, opcodes) or None."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.featurize.kernel import featurize_plan
    plan = featurize_plan(d)
    if d not in _B1_WALKS:
        _B1_WALKS[d] = sass_fast_path(
            _build.library_path("featurize"),
            f"featurize_kernelILi0ELi{plan['points']}E")
    walk = _B1_WALKS[d]
    if walk is None:
        return None
    _, length, ops = walk
    per_elem = length / (2 * plan["points"] * plan["instances"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 4 * 32 * card_clock_mhz() * 1e6     # thread instructions/s
    return m * n * d * per_elem / rate * 1e3, per_elem, ops


def merged_tallies(runs):
    """Launches of every kernel summed over the counted runs (phase 3, each
    counted phase-6 path, phase 7, phase 8's predictor), in total and by
    input shape; ``runs``
    holds each run's (counts, counts by shape)."""
    total = {name: sum(c.get(name, 0) for c, _ in runs) for name in KERNELS}
    tally = {}
    for _, shapes in runs:
        for name, per in shapes.items():
            into = tally.setdefault(name, {})
            for key, k in per.items():
                into[key] = into.get(key, 0) + k
    return total, tally


def b3_times(torch, lay, contrib, label):
    """B3 on ``lay`` (contributions (m, L)): CUDA events, its plain version,
    index_add_ and its bound, which counts the bytes the kernel must move:
    slot and contrib over the tiles' ranges alone (not the layout's slack
    past each instance's last tile), blk_start, and the tables written.
    Returns the kernel table row and the ``by_shape`` times."""
    from repro_torch.kernels.binning import (bin_scatter_blocked_cuda,
                                             scatter_blocked_ref)
    m = lay.slot_lay.shape[0]
    width = lay.num_tiles * lay.block_t
    run = lambda: bin_scatter_blocked_cuda(
        lay.blk_start, lay.slot_lay, contrib, block_n=lay.block_n,
        block_t=lay.block_t)
    tables = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: scatter_blocked_ref(
        lay.slot_lay, contrib, width=width), reps=1, warmup=False)
    flat = (lay.slot_lay.long() + width * torch.arange(
        m, device=contrib.device)[:, None]).view(-1)
    acc = torch.zeros(m * width, device=contrib.device)
    lib = time_ms(torch, lambda: acc.index_add_(0, flat, contrib.view(-1)))
    used = int(lay.blk_start[:, -1].sum()) * lay.block_n
    b = bound(8 * used + nbytes(lay.blk_start, tables), used)
    b_all, _ = bound(nbytes(lay.blk_start, lay.slot_lay, contrib, tables))
    say(f"  B3 {label} (m={m}, L={lay.slot_lay.shape[1]}, block_n="
        f"{lay.block_n}): {ms:.4f} ms; bound over the tiles' ranges "
        f"{b[0]:.4f} ms ({b[0] / ms:.1%} of it; the ranges are "
        f"{used / lay.slot_lay.numel():.1%} of the layout, whose whole "
        f"bytes would take {b_all:.4f} ms); plain {plain:.4f} ms, "
        f"index_add_ {lib:.4f} ms")
    del flat, acc, tables
    return (ms, plain, b, lib), dict(ms=ms, bound_ms=b[0])


def matvec_times(torch, idx, beta, label):
    """B2 as the matvec op runs it (the run totals of beta (n,) in point
    order) on idx's layout, in turns with its first design on beta laid
    out beforehand (new, first, first, new); its plain version and bound;
    beta gathered through src alone (index_select, a yardstick of the
    random reads); the whole op (B2, then the readout over inv_pos) in
    turns with the parent's op (beta laid out, the first design, the map
    back through inv_pos, the mean), and its peak extra allocation.
    Returns the kernel table row, B2's run totals and the times."""
    from repro_torch.kernels.binning import (bin_fused_matvec_cuda,
                                             bin_fused_matvec_op,
                                             fused_matvec_src_ref)
    from repro_torch.kernels.binning.ops import (_beta_to_layout,
                                                 _layout_to_points)
    from repro_torch.kernels.binning.variants import fused_matvec_v1_cuda
    lay = idx.blocked
    (m, L), n = lay.slot_lay.shape, beta.shape[0]
    a = dict(slot_lay=lay.slot_lay, coeff_lay=lay.coeff_lay, src=lay.src,
             beta=beta, totals=True)
    run = lambda: bin_fused_matvec_cuda(**a)
    out = run()
    beta_lay = _beta_to_layout(lay, beta)
    first = lambda: fused_matvec_v1_cuda(
        lay.blk_start, lay.slot_lay, lay.coeff_lay, beta_lay,
        block_n=lay.block_n, block_t=lay.block_t)
    ts = [time_ms(torch, f) for f in (run, first, first, run)]
    ms, v1 = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
    plain = time_ms(torch, lambda: fused_matvec_src_ref(**a), reps=1,
                    warmup=False)
    b = b2_bound(a, out)
    padded = torch.cat([beta, beta.new_zeros(1)])
    gather = time_ms(torch, lambda: padded.index_select(0, lay.src.view(-1)))
    del padded

    def parent_op():
        vals = _layout_to_points(lay, fused_matvec_v1_cuda(
            lay.blk_start, lay.slot_lay, lay.coeff_lay,
            _beta_to_layout(lay, beta), block_n=lay.block_n,
            block_t=lay.block_t))
        return vals.mean(0)
    op = lambda: bin_fused_matvec_op(idx, beta)
    del beta_lay
    ots = [time_ms(torch, f) for f in (op, parent_op, parent_op, op)]
    op_ms, op_v1 = (ots[0] + ots[3]) / 2, (ots[1] + ots[2]) / 2
    peaks = []
    for f in (op, parent_op):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    op_b, _ = bound(nbytes(idx.slot, idx.coeff, beta, beta))
    ro_b, _ = bound(nbytes(lay.inv_pos, idx.coeff, beta) + 4 * m * n)
    say(f"  B2 {label} (m={m}, L={L}, n={n}; {card_line()}): {ms:.4f} ms "
        f"(turns {ts[0]:.4f}, {ts[3]:.4f}); bound {b[0]:.4f} ms by {b[1]} "
        f"({b[0] / ms:.1%} of it); first design {v1:.4f} ms ({ts[1]:.4f}, "
        f"{ts[2]:.4f}; beta laid out beforehand); plain {plain:.4f} ms; "
        f"beta gathered through src alone (index_select) {gather:.4f} ms")
    say(f"  matvec op {label}: {op_ms:.4f} ms (turns {ots[0]:.4f}, "
        f"{ots[3]:.4f}) against the parent's {op_v1:.4f} ms ({ots[1]:.4f}, "
        f"{ots[2]:.4f}); bound {op_b:.4f} ms for its point-order inputs "
        f"(slot, coeff, beta) and output, {b[0] + ro_b:.4f} ms for B2's and "
        f"the readout's bytes; peak extra allocation {peaks[0] / 2**30:.3f} "
        f"GiB against the parent's {peaks[1] / 2**30:.3f} GiB")
    return (ms, plain, b, None), out, dict(
        first_design_ms=v1, gather_ms=gather, op_ms=op_ms,
        parent_op_ms=op_v1, op_bound_ms=op_b, op_peak_bytes=peaks[0],
        parent_op_peak_bytes=peaks[1])


def readout_times(torch, slot, coeff, tables, average):
    """The readout at (m, n, B, k = 1): its default grouping of the
    instances in turns against its first design (B4's gather kernel, then
    the PyTorch combine: new, first, first, new), and 1, 4, 16 and all m
    instances a launch; B4's gather alone, torch.gather alone, the plain
    readout, the byte bound and the 32-byte-sector floor.  Returns the
    kernel table row and the ``by_shape`` times."""
    from repro_torch.kernels.binning import (bin_gather_cuda,
                                             bin_readout_cuda, readout_ref)
    from repro_torch.kernels.binning.kernel import (_readout_launch,
                                                    readout_group)
    m, n = slot.shape
    group = readout_group(m, n, tables.shape[1], 1, torch.cuda.
                          get_device_properties(0).L2_cache_size)
    run = lambda: bin_readout_cuda(slot, coeff, tables, average=average)

    def first():
        signed = coeff * bin_gather_cuda(slot, tables)
        return signed.mean(0) if average else signed.sum(0)
    out = run()
    ts = [time_ms(torch, f) for f in (run, first, first, run)]
    ms, v1 = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
    by_group = {g: time_ms(torch, lambda: _readout_launch(
        slot, coeff, tables, average, g))
        for g in sorted({1, 4, 16, m, group})}
    gather = time_ms(torch, lambda: bin_gather_cuda(slot, tables))
    idx = slot.long()
    lib = time_ms(torch, lambda: torch.gather(tables, 1, idx))
    del idx
    plain = time_ms(torch, lambda: readout_ref(slot, coeff, tables, average),
                    reps=1, warmup=False)
    b = bound(nbytes(slot, coeff, out) + 4 * slot.numel(), 2.0 * slot.numel())
    floor, _ = bound(nbytes(slot, coeff, out) + 32 * slot.numel())
    say(f"  readout (m={m}, n={n}, B={tables.shape[1]}, "
        f"{'mean' if average else 'sum'}): {ms:.4f} ms at {group} "
        f"instance(s) a launch (turns {ts[0]:.4f}, {ts[3]:.4f}); by "
        f"instances a launch " + ", ".join(
            f"{g}: {t:.4f} ms" for g, t in by_group.items())
        + f"; first design (B4 gather + PyTorch combine) {v1:.4f} ms "
        f"({ts[1]:.4f}, {ts[2]:.4f}); B4 gather alone {gather:.4f} ms, "
        f"torch.gather alone {lib:.4f} ms; plain {plain:.4f} ms; bound "
        f"{b[0]:.4f} ms ({b[0] / ms:.1%} of it), sector floor {floor:.4f} "
        f"ms ({floor / ms:.1%})")
    return (ms, plain, b, None), dict(
        ms=ms, bound_ms=b[0], first_design_ms=v1, gather_ms=gather,
        ms_by_group={str(g): t for g, t in by_group.items()})


# phase 8: KRR serving of phase 3's model (the artifact, the predictor's
# graphs, the micro-batcher, the version lifecycle)
SERVE = dict(max_batch=1024, cache_entries=65536, golden=16,
             ragged=(1, 3, 17, 100, 513, 1000, 2500), stream=8192,
             dup_frac=0.5, batch=64, wait_us=2000, paced=2048,
             paced_qps=2000.0, warm_reps=100, life_n=1 << 16,
             life_queries=256)
SERVE_DISK_GIB = 2.1      # the flat artifact of phase 3's model, and room
# B1 and the readout (B4 with its combine), launched from each bucket's graph
SERVE_KERNELS = ("featurize", "bin_readout")


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def serve_warm_times(torch, pred, model, rows):
    """For each bucket: the warm path alone (pinned copy in, replay, copy
    out, synchronize: ``BucketGraph.run``), ``Predictor.predict`` with the
    cache off, and one eager ``wlsh_krr_predict`` of the same rows with its
    copies to and from the card, each the mean of ``warm_reps`` calls on
    the host's clock, in us."""
    import repro_torch.core as T
    hosted = pred._hosted(None)
    out = {}
    for b in sorted(hosted.graphs):
        x = rows[:b]
        g = hosted.graphs[b]

        def warm():
            with hosted.lock:
                g.run(x, hosted.stream)

        fns = {"warm_us": warm,
               "predict_us": lambda: pred.predict(x, use_cache=False),
               "eager_us": lambda: T.wlsh_krr_predict(model, x).cpu()}
        t = {}
        for name, fn in fns.items():
            fn()
            t0 = time.perf_counter()
            for _ in range(SERVE["warm_reps"]):
                fn()
            t[name] = (time.perf_counter() - t0) / SERVE["warm_reps"] * 1e6
        out[b] = t
    return out


def serve_lifecycle(torch, dev, root, seed):
    """ServingRuntime over a version root of artifacts fit at n = 2^16
    (d = m = 64): v1 served, v2 published then poisoned (the canary must
    reject it), v3 torn (invisible), v4 good (swapped in), then rollback()
    to v1.  Device memory in use must fall back to v1's level once v2 is
    rejected and once v4 is rolled away (their graphs and tables
    released).  A counted run of its own: counts reset before the fits and
    read after the last predict; B1, B2, B3 and the readout must launch.
    Returns the steps and (counts, counts by shape)."""
    import repro_torch.core as T
    from repro_torch.data import make_regression
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.serve import (LifecycleConfig, ServingRuntime,
                                   bucket_sizes, discover_versions,
                                   export_artifact, version_dir)
    from repro_torch.testing.faults import poison_artifact_tables, torn_publish
    n, d, m = SERVE["life_n"], MAIN["d"], MAIN["m"]
    x, y, xq, _ = make_regression(n, SERVE["life_queries"], d, rough=0.5,
                                  seed=seed + 1)
    spec = T.WLSHKernelSpec(bucket=T.RECT, pdf=T.GammaPDF(2.0, 1.0))
    reset_launch_counts()
    models, t0 = [], sync_clock(torch)
    for s in (seed + 1, seed + 2):
        lsh = T.sample_lsh_params(np.random.default_rng(s), m, d,
                                  T.GammaPDF(2.0, 1.0), device=dev)
        models.append(T.wlsh_krr_fit(lsh, x, y, spec, lam=MAIN["lam"],
                                     maxiter=MAIN["maxiter"], device=dev))
    t_fit = sync_clock(torch) - t0
    cfg = LifecycleConfig(probation_s=0.0, retain=2,
                          warm_sizes=bucket_sizes(SERVE["batch"]))
    rt = ServingRuntime(root, device=dev, max_batch=SERVE["max_batch"],
                        config=cfg)

    def mem():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def publish(v, model):
        t = time.perf_counter()
        export_artifact(version_dir(root, v), model)
        return time.perf_counter() - t

    steps, levels = [], {}
    t_v1 = publish(1, models[0])
    steps.append(("v1 published", rt.poll_once()))
    levels["v1"] = mem()
    publish(2, models[0])
    poison_artifact_tables(version_dir(root, 2), scale=3.0)
    steps.append(("v2 poisoned", rt.poll_once()))
    levels["v2 rejected"] = mem()
    torn_publish(version_dir(root, 3), models[1])
    steps.append(("v3 torn", rt.poll_once()))
    publish(4, models[1])
    steps.append(("v4 published", rt.poll_once()))
    levels["v4 swapped"] = mem()
    ok_rb = rt.rollback("chip_smoke: rollback to v1")
    steps.append(("rollback()", {"action": "rollback" if ok_rb else
                                 "rollback refused"}))
    levels["rolled back"] = mem()
    active = [(name, r.get("action"), r.get("version")) for name, r in steps]
    served = rt.predict(xq, use_cache=False)
    counts, shapes = launch_counts(), launch_counts_by_shape()
    want = T.wlsh_krr_predict(models[0], xq).cpu().numpy()
    e_plain = check_plain("the lifecycle's v1 after rollback", served,
                          plain_predict(torch, models[0], xq))
    say(f"  lifecycle (fit at n = 2^{n.bit_length() - 1}, d = m = {m}, 2 fits "
        f"{t_fit:.2f} s; a version exports in {t_v1:.2f} s): " + "; ".join(
            f"{name}: {act}" + (f" v{v}" if v else "") for name, act, v in
            active) + f"; served after rollback v{rt.active_version}; "
        f"device memory in use (MiB): " + ", ".join(
            f"{k} {v / 2**20:.1f}" for k, v in levels.items())
        + f"; v1 after rollback within {e_plain:.3g} of the plain path; "
        f"launches (counted run) { {k: v for k, v in counts.items() if v} }"
        f", featurize by (n, d, m) {shapes['featurize']}, readout by (m, n, "
        f"B, k) {shapes['bin_readout']}")
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"phase 8 lifecycle: kernels not launched: {missing}")
    expect = (("v1 published", "swap"), ("v2 poisoned", "canary_reject"),
              ("v3 torn", "none"), ("v4 published", "swap"),
              ("rollback()", "rollback"))
    got = tuple((name, act) for name, act, _ in active)
    if got != expect or rt.active_version != 1:
        fail(f"phase 8 lifecycle: {got}, active v{rt.active_version}")
    if 3 in [v for v, _ in discover_versions(root)]:
        fail("phase 8 lifecycle: the torn v3 is visible")
    if levels["v2 rejected"] > levels["v1"] or \
            levels["rolled back"] > levels["v1"] or \
            not levels["v4 swapped"] > levels["v1"]:
        fail(f"phase 8 lifecycle: device memory did not fall back: {levels}")
    if not np.array_equal(served, want):
        fail("phase 8 lifecycle: v1 after rollback differs from "
             "wlsh_krr_predict")
    return active, (counts, shapes)


def phase_serving(torch, data, model, seed):
    """Phase 8: export phase 3's model, serve it through the Predictor's
    graphs and the MicroBatcher, then the version lifecycle."""
    import shutil
    import tempfile
    import repro_torch.core as T
    from repro_torch import obs
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.launch.krr_serve import _synthetic_stream, serve_stream
    from repro_torch.serve import Predictor, bucket_sizes, export_artifact
    say("== phase 8: KRR serving of phase 3's model (artifact, a CUDA graph "
        "per padding bucket, micro-batcher, lifecycle)")
    dev = data[0].device
    xq = data[2]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < SERVE_DISK_GIB * 2**30:
            fail(f"phase 8: {free / 2**30:.2f} GiB free under {tmp}, the "
                 f"artifact needs {SERVE_DISK_GIB} GiB")
        art = f"{tmp}/artifact"
        t0 = time.perf_counter()
        export_artifact(art, model, include_beta=False,
                        golden_queries=SERVE["golden"])
        t_export = time.perf_counter() - t0
        size = dir_bytes(art)

        pred = Predictor(device=dev, max_batch=SERVE["max_batch"],
                         cache_entries=SERVE["cache_entries"])
        obs.clear_span_samples("io.validate_artifact")
        t0 = sync_clock(torch)
        aid = pred.load(art)
        t_load = sync_clock(torch) - t0
        t_valid = sum(obs.span_samples_us("io.validate_artifact")) / 1e6
        say(f"  export {t_export:.2f} s, {size} bytes on disk; load "
            f"{t_load:.2f} s onto the card, of it {t_valid:.3f} s the "
            f"host's scan of the tables for non-finite values")
        meta = pred._hosted(aid).loaded.meta
        golden = meta["golden"]

        # the counted run: warmup, a request at every bucket's size and
        # ragged and over-size ones, the golden block, the streams;
        # comparisons after it
        sizes = sorted(set(SERVE["ragged"]) |
                       set(bucket_sizes(SERVE["max_batch"])))
        rows = xq[:max(sizes)].cpu().numpy()
        stream = _synthetic_stream(MAIN["d"], SERVE["stream"],
                                   SERVE["dup_frac"], seed)
        reset_launch_counts()
        t0 = time.perf_counter()
        n_graphs = pred.warmup()
        t_warmup = time.perf_counter() - t0
        if n_graphs != len(bucket_sizes(SERVE["max_batch"])):
            fail(f"phase 8: warmup captured {n_graphs} graphs, not "
                 f"{len(bucket_sizes(SERVE['max_batch']))}")
        served = {b: pred.predict(rows[:b], use_cache=False)
                  for b in sizes}
        got_golden = pred.predict(np.asarray(golden["x"], np.float32),
                                  use_cache=False)
        stats = serve_stream(pred, stream, max_batch=SERVE["batch"],
                             max_wait_us=SERVE["wait_us"])
        # the same traffic paced at a rate the card keeps up with: the
        # latency a request sees without a backlog
        paced = _synthetic_stream(MAIN["d"], SERVE["paced"],
                                  SERVE["dup_frac"], seed + 1)
        pstats = serve_stream(pred, paced, max_batch=SERVE["batch"],
                              max_wait_us=SERVE["wait_us"],
                              target_qps=SERVE["paced_qps"])
        counts, shapes = launch_counts(), launch_counts_by_shape()
        graphs = pred.graph_stats()
        if pred.compile_count() != n_graphs:
            fail(f"phase 8: graphs {n_graphs} -> {pred.compile_count()} "
                 f"after ragged and over-size requests")
        missing = [k for k in SERVE_KERNELS if counts[k] <= 0 or not any(
            k in g["launches"] and g["replays"] > 0 for g in graphs.values())]
        if missing:
            fail(f"phase 8: kernels not replayed from the graphs: {missing}")
        replays = {b: g["replays"] for b, g in graphs.items()}
        cache = pred.cache_stats()
        say(f"  {n_graphs} graphs captured in {t_warmup:.2f} s (each "
            f"records {graphs[1]['launches']} launches); still "
            f"{pred.compile_count()} after requests of {sizes} rows; "
            f"replays by bucket {replays}; launches (counted run: eager "
            f"runs before each capture, then one a recorded launch a "
            f"replay) { {k: v for k, v in counts.items() if v} }")
        say(f"  stream: {stats['served']} single-row requests "
            f"(dup_frac {SERVE['dup_frac']}, max_batch {SERVE['batch']}, "
            f"max_wait_us {SERVE['wait_us']}): p50 {stats['p50_us']:.1f} "
            f"us, p99 {stats['p99_us']:.1f} us, {stats['qps']:.0f} QPS, "
            f"{stats['batches']} batches of mean {stats['mean_batch']:.2f} "
            f"rows, cache hit rate {cache['hit_rate']:.3f} ({cache['hits']} "
            f"hits, {cache['misses']} misses)")
        say(f"  paced stream: {pstats['served']} requests offered at "
            f"{SERVE['paced_qps']:.0f} QPS: p50 {pstats['p50_us']:.1f} us, "
            f"p99 {pstats['p99_us']:.1f} us, {pstats['qps']:.0f} QPS, "
            f"{pstats['batches']} batches of mean "
            f"{pstats['mean_batch']:.2f} rows")

        # comparisons, outside the counted run: bitwise against the
        # library path (the same kernels, eager) and within 1e-5 of max|pred|
        # of the plain path on the same rows
        e_plain = 0.0
        for b, out in served.items():
            want = T.wlsh_krr_predict(model, rows[:b]).cpu().numpy()
            if not np.array_equal(out, want):
                fail(f"phase 8: a request of {b} rows differs from "
                     f"wlsh_krr_predict by {np.abs(out - want).max()}")
            e_plain = max(e_plain, check_plain(
                f"a request of {b} rows", out,
                plain_predict(torch, model, rows[:b])))
        gerr = float(np.abs(got_golden - np.asarray(golden["y"])).max())
        if not gerr <= golden["tol"]:
            fail(f"phase 8: golden block off by {gerr} > {golden['tol']}")
        want = T.wlsh_krr_predict(model, stream).cpu().numpy()
        res = stats["results"]
        if stats["served"] != SERVE["stream"] or not np.array_equal(res,
                                                                    want):
            fail(f"phase 8: stream served {stats['served']}; differs from "
                 f"wlsh_krr_predict on {int((res != want).sum())} rows")
        pwant = T.wlsh_krr_predict(model, paced).cpu().numpy()
        if pstats["served"] != SERVE["paced"] or \
                not np.array_equal(pstats["results"], pwant):
            fail("phase 8: the paced stream differs from wlsh_krr_predict")
        e_plain = max(e_plain, check_plain(
            "the stream", res, plain_predict(torch, model, stream)),
            check_plain("the paced stream", pstats["results"],
                        plain_predict(torch, model, paced)))
        first = {}
        for i, r in enumerate(stream):
            j = first.setdefault(r.tobytes(), i)
            if res[i] != res[j]:
                fail(f"phase 8: repeat of request {j} served differently")
        say(f"  every answer bitwise equal to wlsh_krr_predict on its rows "
            f"(requests of {sizes} rows and both streams; repeats equal "
            f"their first answer) and within {e_plain:.3g} of the plain "
            f"path (featurize_ref, readout_ref; limit 1e-5 of max|pred|); "
            f"golden block within {gerr:.3g} (tol {golden['tol']})")

        warm = serve_warm_times(torch, pred, model, rows)
        say("  by bucket, us (host clock, mean of "
            f"{SERVE['warm_reps']}): warm path (pinned copy in, replay, "
            f"copy out, sync) / predict() / eager wlsh_krr_predict: " +
            ", ".join(f"{b}: {t['warm_us']:.1f} / {t['predict_us']:.1f} / "
                      f"{t['eager_us']:.1f}" for b, t in warm.items()))
        life, life_counts = serve_lifecycle(torch, dev, f"{tmp}/versions",
                                            seed)
    return dict(predictor=pred, counts=(counts, shapes), graphs=graphs,
                warm=warm, lifecycle=life, lifecycle_counts=life_counts)


def serve_graph_times(torch, serving):
    """Phase 5's part of phase 8: one replay of each bucket's graph, by
    CUDA events over replays back to back and by the device time of its
    kernels (torch.profiler), and that busy time's share of the warm
    path's wall (phase 8, host clock)."""
    pred = serving["predictor"]
    hosted = pred._hosted(None)
    out = {}
    for b, g in sorted(hosted.graphs.items()):
        with hosted.lock:
            ev = time_ms(torch, g.graph.replay, reps=100)
            split = device_split(torch, g.graph.replay)
        wall_ms = serving["warm"][b]["warm_us"] / 1e3
        busy = sum(split.values()) if split else None
        out[b] = dict(replay_ms=ev, busy_ms=busy, warm_ms=wall_ms)
        say(f"  graph of bucket {b}: replay {ev * 1e3:.2f} us (events, "
            f"back to back); device busy " + (
                "not measured (no device events)" if busy is None else
                f"{busy * 1e3:.2f} us a replay ("
                + ", ".join(f"{kernel_name(k)} {v * 1e3:.2f}"
                            for k, v in sorted(split.items()))
                + f"), {busy / wall_ms:.1%} of the warm path's "
                f"{wall_ms * 1e3:.1f} us"))
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper's Tables 1 and 2 at their own sizes, and the exact
# estimator at the main config
# ---------------------------------------------------------------------------

# Table 1 (benchmarks/table1_gp.py at scale 1): GP data on [0, 1]^d, exact
# KRR with each covariance and exact-mode WLSH, its lengthscale picked on a
# validation split from ells * ell_d
TABLE1 = dict(n_train=3000, n_test=1000, dims=(5, 30), noise=0.05, lam=0.05,
              m=450, ells=(0.125, 0.25, 0.5, 1.0))
# Table 2 (benchmarks/table2_krr.py:26-31's grid at scale 1): dataset, m,
# D_rff; lam as there
TABLE2 = (("wine", 450, 1024), ("insurance", 250, 1024),
          ("ct_slices", 64, 512), ("forest", 64, 256))
TABLE2_LAM = 0.5
# the Table 2 dataset whose layout phase 5 times B2 and the matvec op at:
# forest's, where a few slots hold most of an instance's 500k points
# (phase 9 prints the skew)
KEEP_LAYOUT = "forest"
# the memory exact KRR may take when phase 9 runs on the CPU (a rehearsal);
# on the card it is the free device memory
CPU_EXACT_BYTES = 4 << 30
# the kernels of (a)'s exact-mode fits and predictions, each launched there
# or the run fails: B1, the point scatter B5 (tables from an index without
# a layout), the readout; (b)'s table-mode fits run the main path's four
TABLE1_KERNELS = ("featurize", "bin_scatter", "bin_readout")
# phase 9 allows a summing kernel, beyond 1e-5 of max|out|, ROUND_UNITS
# sqrt(n) units of float32 rounding (2^-24) of an output's sum of absolute
# terms, n the number of terms: two float32 sums of them in any orders,
# each within lambda sqrt(n) u sum|x| (Higham and Mary's probabilistic
# bound) at lambda = 4
ROUND_UNITS = 8.0
# phase 9's kernels: the wrapper each calls, by its name in its ops module
HELD = {"featurize": ("repro_torch.kernels.featurize.ops", "featurize_cuda"),
        **{name: ("repro_torch.kernels.binning.ops", f"{name}_cuda")
           for name in ("bin_fused_matvec", "bin_scatter_blocked",
                        "bin_scatter", "bin_readout")}}


def plain_err(torch, name, a, got, what) -> dict:
    """Kernel ``name``'s output ``got`` on the bound arguments ``a``
    against its plain version on the same inputs.  B1 at phase 2's limits:
    keys, slot and sign bitwise, weight and coeff to atol 2e-6.  The
    kernels that sum (B2, B3, B5, the readout) to 1e-5 of max|out| plus,
    for each output, ROUND_UNITS sqrt(n) units of float32 rounding of its
    sum of absolute terms (the plain version on |inputs|; n, its number
    of terms, from the plain version on ones): where the terms cancel,
    two orders of the plain float32 sum differ by more than 1e-5 of
    max|out| (PERF.md, PR 18).  Returns the error (``err``), its
    largest share of the limit (``share``), the largest absolute sum over
    max|out| (``cond``), for B5 how far the plain sum in reversed point
    order lies from it (``spread``), and whether the comparison could see
    a fault (``seen``: an output of zeros, as a solve's first residual
    from x0 = 0 gives, cannot)."""
    from repro_torch.kernels.binning import (fused_matvec_src_ref,
                                             readout_ref,
                                             scatter_blocked_ref, scatter_ref)
    from repro_torch.kernels.featurize import featurize_ref
    if name == "featurize":
        err = compare_featurize(torch, got, featurize_ref(**a), what)
        return dict(err=err, share=err / 2e-6, seen=True)
    if name == "bin_fused_matvec":
        plain = lambda f: fused_matvec_src_ref(
            a["slot_lay"], f(a["coeff_lay"]), a["src"], f(a["beta"]),
            totals=a["totals"])
    elif name == "bin_scatter_blocked":
        plain = lambda f: scatter_blocked_ref(
            a["slot_lay"], f(a["contrib_lay"]), width=got.shape[-1])
    elif name == "bin_scatter":
        plain = lambda f: scatter_ref(a["slot"], f(a["contrib"]),
                                      table_size=a["table_size"])
    else:
        plain = lambda f: readout_ref(a["slot"], f(a["coeff"]),
                                      f(a["tables"]), a["average"])
    want = plain(lambda t: t)
    if not want.numel():
        return dict(err=0.0, share=0.0, seen=False)
    diff = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    abs_sum = plain(torch.abs).double()
    terms = (a["slot"].shape[0] if name == "bin_readout"
             else plain(torch.ones_like).double())
    lim = 1e-5 * top + ROUND_UNITS * 2.0 ** -24 * abs_sum * terms ** 0.5
    share = float((diff / lim).nan_to_num(0.0).max())
    if not share <= 1.0:
        fail(f"{name} {what}: err {float(diff.max())} past its limit "
             f"({share:.3g} of it at the worst output)")
    out = dict(err=float(diff.max()), share=share,
               seen=bool((lim > 0).any()),
               cond=float(abs_sum.max()) / top if top else 0.0)
    if name == "bin_scatter":
        out["spread"] = max_err(scatter_ref(
            a["slot"].flip(1), a["contrib"].flip(1),
            table_size=a["table_size"]), want) / top if top else 0.0
    return out


class HeldToPlain:
    """While open, the ops modules call phase 9's kernels through wrappers
    that launch the kernel (counted as always) and, the first time it
    meets a shape of inputs, hold its output against its plain version on
    the same inputs (``plain_err``; the plain version launches nothing),
    again at each call of that shape until an output is not all zeros.
    Each kernel's inputs at its largest shape (by bytes) are kept, copied,
    for phase 5 to time."""

    def __init__(self, torch):
        self.torch = torch
        # name: {shape: plain_err's result}
        self.errs = {name: {} for name in HELD}
        self.zeros = {name: set() for name in HELD}  # all-zero outputs
        # name: (bytes, shape, arguments, output not all zeros)
        self.largest = {}

    def __enter__(self):
        import importlib
        self.saved = []
        for name, (module, attr) in HELD.items():
            mod = importlib.import_module(module)
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self._held(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def _held(self, name, fn):
        import inspect
        torch, sig = self.torch, inspect.signature(fn)

        def run(*args, **kw):
            out = fn(*args, **kw)
            bound_args = sig.bind(*args, **kw)
            bound_args.apply_defaults()
            a = bound_args.arguments
            shape = tuple(tuple(v.shape) if isinstance(v, torch.Tensor)
                          else getattr(v, "name", v) for v in a.values())
            if shape not in self.errs[name]:
                res = plain_err(torch, name, a, out, f"at {shape}")
                if res["seen"]:
                    self.errs[name][shape] = res
                else:
                    self.zeros[name].add(shape)
            size = nbytes(*(v for v in a.values()
                            if isinstance(v, torch.Tensor)))
            seen = shape in self.errs[name]
            best = self.largest.get(name, (-1, None, None, False))
            if size > best[0] or (size == best[0] and seen and not best[3]):
                self.largest[name] = (size, shape, {
                    k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in a.items()}, seen)
            return out
        return run

    def summary(self) -> str:
        parts = []
        for name, e in self.errs.items():
            zero = self.zeros[name] - set(e)
            if e or zero:
                top = lambda k: max((v.get(k, 0.0) for v in e.values()),
                                    default=0.0)
                worst = max(e, key=lambda sh: e[sh]["share"], default=None)
                parts.append(
                    f"{name} at {len(e)} shape(s), max err "
                    f"{top('err'):.3g}, {top('share'):.3g} of its limit"
                    f" (at {worst})"
                    + (f", absolute sums up to {top('cond'):.4g} x max|out|"
                       if name != "featurize" else "")
                    + (f", the plain sum in reversed order off by "
                       f"{top('spread'):.3g} of max|out|"
                       if name == "bin_scatter" else "") + (
                        f" ({len(zero)} more with only all-zero outputs)"
                        if zero else ""))
        return "; ".join(parts)


def rmse(torch, a, b) -> float:
    return float(torch.sqrt(((a - b) ** 2).mean()))


def table1_rows(torch, dev, seed, cfg=TABLE1):
    """Table 1's rows: for each d and covariance, the test RMSE against the
    noiseless GP of exact KRR with each covariance and of exact-mode
    WLSH (smooth, Gamma(7, 1) at d <= 10; rect, Gamma(2, 1) above)."""
    import repro_torch.core as T
    from repro_torch.core.gp import gp_regression_dataset
    covs = {"sqexp": T.gaussian_kernel, "laplace": T.laplace_kernel,
            "matern52": T.matern52_kernel}
    n_train, n_test, lam, m = (cfg["n_train"], cfg["n_test"], cfg["lam"],
                               cfg["m"])
    n_val = max(50, n_test // 4)
    rows = []
    for d in cfg["dims"]:
        # distances on [0, 1]^d concentrate at ~sqrt(d / 6): every
        # lengthscale scales with it, as in the JAX script
        ell_d = max(1.0, (d / 6.0) ** 0.5)
        bucket, pdf = ((T.SMOOTH, T.GammaPDF(7.0, 1.0)) if d <= 10
                       else (T.RECT, T.GammaPDF(2.0, 1.0)))

        def wlsh(ell, xa, ya):
            lsh = T.sample_lsh_params(np.random.default_rng(seed + d + 1), m,
                                      d, pdf, ell, device=dev)
            spec = T.WLSHKernelSpec(bucket=bucket, pdf=pdf, lengthscale=ell)
            return T.wlsh_krr_fit(lsh, xa, ya, spec, lam=lam, mode="exact",
                                  device=dev)

        for cov_name, cov0 in covs.items():
            cov = lambda a, b, k=cov0: k(a, b, lengthscale=ell_d)
            t0 = sync_clock(torch)
            x, y, f = gp_regression_dataset(np.random.default_rng(seed + d),
                                            cov, n=n_train + n_test, d=d,
                                            noise=cfg["noise"], device=dev)
            t1 = sync_clock(torch)
            xtr, ytr, xte, fte = x[:n_train], y[:n_train], x[n_train:], \
                f[n_train:]
            row = dict(cov=cov_name, d=d, gp_s=t1 - t0)
            for fit_name, fit0 in covs.items():
                fit_k = lambda a, b, k=fit0: k(a, b, lengthscale=ell_d)
                beta = T.exact_krr_fit(fit_k, xtr, ytr, lam)
                row[fit_name] = rmse(torch, T.exact_krr_predict(
                    fit_k, xtr, beta, xte), fte)
            t2 = sync_clock(torch)
            best = (float("inf"), None)
            for s in cfg["ells"]:
                mod = wlsh(s * ell_d, xtr[:-n_val], ytr[:-n_val])
                vr = rmse(torch, T.wlsh_krr_predict(mod, xtr[-n_val:]),
                          ytr[-n_val:])
                if vr < best[0]:
                    best = (vr, s * ell_d)
            t3 = sync_clock(torch)
            model = wlsh(best[1], xtr, ytr)
            row["wlsh"] = rmse(torch, T.wlsh_krr_predict(model, xte), fte)
            t4 = sync_clock(torch)
            row.update(wlsh_ell=best[1], wlsh_iters=model.telemetry["iters"],
                       exact_s=t2 - t1, select_s=t3 - t2, wlsh_s=t4 - t3)
            rows.append(row)
    return rows


def table1_verdict(row) -> bool:
    """The JAX script's own test (benchmarks/table1_gp.py:90-98): smooth
    WLSH within 2x (+0.08) of the best classical kernel at d <= 10; rect
    WLSH within 1.3x (+0.02) of its own exact kernel, Laplace, above."""
    vals = [row[k] for k in ("laplace", "sqexp", "matern52", "wlsh")]
    if not all(np.isfinite(vals)):
        return False
    if row["d"] <= 10:
        return row["wlsh"] < 2.0 * min(vals[:3]) + 0.08
    return row["wlsh"] < 1.3 * row["laplace"] + 0.02


def median_dists(x: np.ndarray, seed: int, k: int = 256):
    """Median L1 and L2 pairwise distance on a subsample of k rows drawn
    with numpy (the median heuristic of benchmarks/table2_krr.py:38-57)."""
    rng = np.random.default_rng(seed + 3)
    xs = x[rng.choice(x.shape[0], min(k, x.shape[0]), replace=False)]
    diff = xs[:, None, :] - xs[None, :, :]
    return (float(np.median(np.abs(diff).sum(-1))),
            float(np.median(np.sqrt((diff * diff).sum(-1)))))


def exact_krr_bytes(n: int, n_test: int) -> int:
    """The float32 bytes exact KRR holds at its peak: the n x n kernel,
    its shifted copy and the solve's LU factor (or, predicting, the
    n_test x n test kernel), and two row blocks of the pairwise
    differences."""
    from repro_torch.core.kernels import PAIRWISE_BLOCK_ELEMS
    return 4 * (n * max(3 * n, n_test) + 2 * PAIRWISE_BLOCK_ELEMS)


def table2_rows(torch, dev, seed, grid=TABLE2, scale=1.0):
    """Table 2's rows: exact Laplace KRR where its peak memory fits the
    device's free memory, RFF and table-mode WLSH (rect) on every dataset;
    RMSE and fit seconds, and the RMSE of predicting the training mean."""
    import repro_torch.core as T
    from repro_torch.data import make_regression_dataset
    rows = []
    for name, m, d_rff in grid:
        t0 = time.perf_counter()
        xtr, ytr, xte, yte = make_regression_dataset(name, seed, scale=scale)
        l1, l2 = median_dists(xtr, seed)
        ell1, ell2 = l1 / 2.0, l2
        n, d = xtr.shape
        xtr, ytr, xte, yte = (torch.from_numpy(a).to(dev)
                              for a in (xtr, ytr, xte, yte))
        row = dict(dataset=name, n=n, d=d, n_test=xte.shape[0], m=m,
                   d_rff=d_rff, data_s=time.perf_counter() - t0,
                   mean_rmse=rmse(torch, ytr.mean(), yte))
        need = exact_krr_bytes(n, xte.shape[0])
        free = (torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda"
                else CPU_EXACT_BYTES)
        if need <= free:
            kern = lambda a, b: T.laplace_kernel(a, b, ell1)
            t0 = sync_clock(torch)
            beta = T.exact_krr_fit(kern, xtr, ytr, TABLE2_LAM)
            row["exact_s"] = sync_clock(torch) - t0
            row["exact_rmse"] = rmse(torch, T.exact_krr_predict(
                kern, xtr, beta, xte), yte)
            del beta
        else:
            row["exact_skip"] = (
                f"it needs about {need / 1e9:.3g} GB (the {n} x {n} "
                f"kernel, its shifted copy and the solve's factor), "
                f"{free / 1e9:.3g} GB are free on the {dev.type}")
        t0 = sync_clock(torch)
        rmod = T.rff_krr_fit(np.random.default_rng(seed + 1), xtr, ytr,
                             n_features=d_rff, lam=TABLE2_LAM,
                             lengthscale=ell2, device=dev)
        row["rff_s"] = sync_clock(torch) - t0
        row["rff_rmse"] = rmse(torch, T.rff_krr_predict(rmod, xte), yte)
        t0 = sync_clock(torch)
        lsh = T.sample_lsh_params(np.random.default_rng(seed + 2), m, d,
                                  T.GammaPDF(2.0, 1.0), ell1, device=dev)
        spec = T.WLSHKernelSpec(bucket=T.RECT, lengthscale=ell1)
        wmod = T.wlsh_krr_fit(lsh, xtr, ytr, spec, lam=TABLE2_LAM,
                              device=dev)
        row["wlsh_s"] = sync_clock(torch) - t0
        row["wlsh_rmse"] = rmse(torch, T.wlsh_krr_predict(wmod, xte), yte)
        row["wlsh_iters"] = wmod.telemetry["iters"]
        if name == KEEP_LAYOUT:
            row["keep"] = (wmod, xtr)     # for phase 5: B2 at this layout
        rows.append(row)
        del wmod, rmod, xtr, ytr, xte, yte
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def skew_stats(torch, slot) -> dict:
    """Per instance of slot (m, n): its distinct slots and the points on
    its most popular one; min, median and max of each over the
    instances."""
    distinct, largest = [], []
    for row in slot:
        _, counts = torch.unique(row, return_counts=True)
        distinct.append(counts.numel())
        largest.append(int(counts.max()))
    return {name: (min(v), int(np.median(v)), max(v))
            for name, v in (("distinct", distinct), ("largest", largest))}


def kept_layout(keep):
    """The slot-blocked index of a Table 2 fit's training points, built as
    its fit built it (outside the counted runs), and its beta."""
    import repro_torch.core as T
    wmod, xtr = keep
    op = T.model_operator(wmod)
    idx = op.build_index(op.featurize(xtr), blocked=True)
    return idx, wmod.beta


def exact_at_main(torch, data, model):
    """(c): the exact estimator at phase 3's points (n = 2^22, d = 64,
    m = 64): build_exact_index and one exact_matvec by CUDA events.  Phase
    3 times the table index's layout and phase 5 the table matvec on the
    same points."""
    import repro_torch.core as T
    x, beta = data[0], model.beta
    feats = T.model_operator(model).featurize(x)
    m, n = feats.key1.shape
    t_index = time_ms(torch, lambda: T.build_exact_index(feats), reps=3)
    eidx = T.build_exact_index(feats)
    del feats
    t_exact = time_ms(torch, lambda: T.exact_matvec(eidx, beta))
    out = T.exact_matvec(eidx, beta)
    if out.shape != (n,) or not bool(torch.isfinite(out).all()):
        fail("phase 9 (c): exact matvec not finite or of the wrong shape")
    buckets = (eidx.seg_id[:, -1].double() + 1).mean().item()
    # the exact matvec must read perm, seg_id and weight (m n each) and
    # beta, and write its output: its byte floor
    floor, _ = bound(3 * 4 * m * n + 2 * 4 * n)
    del eidx, out
    if x.device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(n=n, m=m, index_ms=t_index, exact_ms=t_exact,
                exact_floor_ms=floor, buckets=buckets)


def phase_tables(torch, data, model, seed, cfg=TABLE1, grid=TABLE2,
                 scale=1.0):
    """Phase 9: the paper's Tables 1 and 2 through the port on the card,
    every kernel launch held to its plain version at each new shape, then
    the exact estimator at the main config.  Returns the launches of (a)
    and (b), the counted runs, summed; the ``HeldToPlain`` with the
    largest shapes' inputs; (c)'s times; and KEEP_LAYOUT's index, beta,
    name and skew (phase 5 times B2 and the matvec op there)."""
    import repro_torch.core as T
    from repro_torch.kernels import launch_counts, reset_launch_counts
    say("== phase 9: the paper's Table 1 (GP RMSE by kernel) and Table 2 "
        "(exact vs RFF vs WLSH) at their own sizes")
    dev = data[0].device
    t_start = sync_clock(torch)
    with HeldToPlain(torch) as held:
        reset_launch_counts()
        rows1 = table1_rows(torch, dev, seed, cfg)
        counts_a = launch_counts()
        t1 = sync_clock(torch)
        c = cfg
        say(f"  (a) Table 1: n_train {c['n_train']}, n_test {c['n_test']}, "
            f"noise {c['noise']}, lam {c['lam']}, m {c['m']}; test RMSE "
            f"against the noiseless GP; {t1 - t_start:.1f} s")
        say("  cov,d,laplace,sqexp,matern52,wlsh,wlsh_ell,wlsh_iters,gp_s,"
            "exact_s,select_s,wlsh_s,passes")
        bad = []
        for r in rows1:
            ok = table1_verdict(r)
            say(f"  {r['cov']},{r['d']},{r['laplace']:.4f},{r['sqexp']:.4f},"
                f"{r['matern52']:.4f},{r['wlsh']:.4f},{r['wlsh_ell']:.4g},"
                f"{r['wlsh_iters']},{r['gp_s']:.3f},{r['exact_s']:.3f},"
                f"{r['select_s']:.3f},{r['wlsh_s']:.3f},{ok}")
            if not ok:
                bad.append((r["cov"], r["d"]))
        say(f"  (a) launches {counts_a}")
        missing = [k for k in TABLE1_KERNELS if counts_a[k] <= 0]
        if missing:
            fail(f"phase 9 (a): kernels not launched: {missing}")
        if bad:
            fail(f"phase 9 (a): Table 1 rows miss the script's test: {bad}")

        # outside the counts: exact mode on the card against the CPU, on
        # the features of one d = 5 instance set at Table 1's size
        d = c["dims"][0]
        rng = np.random.default_rng(seed)
        lsh = T.sample_lsh_params(rng, c["m"], d, T.GammaPDF(7.0, 1.0),
                                  device=dev)
        x = torch.from_numpy(rng.random((c["n_train"], d),
                                        dtype=np.float32))
        feats = T.make_operator(lsh, T.SMOOTH, 1 << 14,
                                device=dev).featurize(x.to(dev))
        host = T.Features(*(t.cpu() for t in feats[:4]))
        got, want = T.build_exact_index(feats), T.build_exact_index(host)
        same = all(torch.equal(getattr(got, k).cpu(), getattr(want, k))
                   for k in ("perm", "seg_id"))
        beta = torch.from_numpy(rng.standard_normal(c["n_train"],
                                                    dtype=np.float32))
        ref = T.exact_matvec(want, beta)
        err = max_err(T.exact_matvec(got, beta.to(dev)).cpu(), ref)
        lim = 1e-5 * float(ref.abs().max())
        say(f"  exact mode, card against CPU (n {c['n_train']}, d {d}, m "
            f"{c['m']}, smooth): perm and seg_id bitwise {same}; matvec max "
            f"err {err:.3g} (limit {lim:.3g}, 1e-5 of max|out|)")
        if not same:
            fail("phase 9: the card's exact index differs from the CPU's")
        if err > lim:
            fail(f"phase 9: exact matvec on the card differs by {err} > "
                 f"{lim}")
        del feats, got

        t2 = sync_clock(torch)
        reset_launch_counts()
        rows2 = table2_rows(torch, dev, seed, grid, scale)
        counts_b = launch_counts()
    t3 = sync_clock(torch)
    say(f"  (b) Table 2 at scale {scale} (lam {TABLE2_LAM}; RMSE on the "
        f"test split, fit seconds; mean = predicting the training mean); "
        f"{t3 - t2:.1f} s")
    say("  dataset,n,d,m,D_rff,exact_rmse,exact_s,rff_rmse,rff_s,wlsh_rmse,"
        "wlsh_s,wlsh_iters,mean_rmse,wlsh/mean,data_s")
    bad = []
    for r in rows2:
        ex = (f"{r['exact_rmse']:.4f},{r['exact_s']:.3f}"
              if "exact_rmse" in r else "-,-")
        ratio = r["wlsh_rmse"] / r["mean_rmse"]
        say(f"  {r['dataset']},{r['n']},{r['d']},{r['m']},{r['d_rff']},{ex},"
            f"{r['rff_rmse']:.4f},{r['rff_s']:.3f},{r['wlsh_rmse']:.4f},"
            f"{r['wlsh_s']:.3f},{r['wlsh_iters']},{r['mean_rmse']:.4f},"
            f"{ratio:.3f},{r['data_s']:.2f}")
        if "exact_skip" in r:
            say(f"    exact KRR skipped at {r['dataset']}: {r['exact_skip']}")
        vals = [r["rff_rmse"], r["wlsh_rmse"], r.get("exact_rmse", 0.0)]
        if not all(np.isfinite(vals)) or not ratio < 1.0:
            bad.append(r["dataset"])
    say(f"  (b) launches {counts_b}")
    kept = None
    for r in rows2:
        if "keep" in r:
            kept = kept_layout(r.pop("keep"))
            sk = skew_stats(torch, kept[0].slot)
            say(f"  {r['dataset']}'s layout (m {r['m']}, n {r['n']}, L "
                f"{kept[0].blocked.slot_lay.shape[1]}): distinct slots an "
                f"instance min/median/max {sk['distinct']}, points on its "
                f"largest slot {sk['largest']}")
            kept = kept + (r["dataset"], sk)
    missing = [k for k in MAIN_KERNELS if counts_b[k] <= 0]
    if missing:
        fail(f"phase 9 (b): kernels not launched: {missing}")
    if bad:
        fail(f"phase 9 (b): non-finite RMSE, or WLSH not below the mean "
             f"predictor: {bad}")
    say(f"  (a) and (b) held to the plain versions at every shape "
        f"launched: {held.summary()}")

    ex = exact_at_main(torch, data, model)
    say(f"  (c) exact estimator at phase 3's points (n {ex['n']}, d "
        f"{data[0].shape[1]}, m {ex['m']}; {card_line()}): "
        f"build_exact_index {ex['index_ms']:.3f} ms, exact_matvec "
        f"{ex['exact_ms']:.3f} ms (byte floor {ex['exact_floor_ms']:.3f}); "
        f"{ex['buckets']:.0f} buckets an instance; the table matvec beside "
        f"it in phase 5")
    say(f"  phase 9 {sync_clock(torch) - t_start:.1f} s")
    counts = {k: counts_a.get(k, 0) + counts_b.get(k, 0) for k in KERNELS}
    return counts, held, ex, kept


def b2_bound(a, out):
    """B2's bound on its arguments ``a``: slot, coeff and src read once,
    beta once and the output written once, and a multiply and an add a
    position and column."""
    return bound(nbytes(a["slot_lay"], a["coeff_lay"], a["src"], a["beta"],
                        out), 2.0 * out.numel())


def held_bound(name, a, out):
    """The bound of one call of phase 9's kernel ``name`` on ``a``: the
    bytes of its inputs and outputs (B3 over the tiles' ranges alone, the
    readout one table read a point and instance) and its operations, as
    phase 5 bounds the kernel at the main phase's shapes."""
    if name == "featurize":
        (n, d), m = a["x"].shape, a["w"].shape[0]
        return bound(nbytes(a["x"], a["w"], a["z"], a["r1"], a["r2"], *out),
                     5.0 * m * n * d)
    if name == "bin_fused_matvec":
        return b2_bound(a, out)
    if name == "bin_scatter_blocked":
        c = a["contrib_lay"]
        k = c.shape[1] if c.ndim == 3 else 1
        used = int(a["blk_start"][:, -1].sum()) * a["block_n"]
        return bound((4 + 4 * k) * used + nbytes(a["blk_start"], out),
                     k * used)
    if name == "bin_scatter":
        return bound(nbytes(a["slot"], a["contrib"], out))
    k = a["tables"].shape[2] if a["tables"].ndim == 3 else 1
    pts = a["slot"].numel()
    return bound(nbytes(a["slot"], a["coeff"], out) + 4 * k * pts,
                 2.0 * k * pts)


def held_times(torch, held):
    """Phase 9's kernels at their largest shapes there (the inputs
    ``HeldToPlain`` kept), by CUDA events: the ``tables_*`` keys of the
    kernels line."""
    from repro_torch.kernels import KERNEL_WRAPPERS
    extra = {}
    for name, (_, shape, a, _) in held.largest.items():
        run = lambda: KERNEL_WRAPPERS[name](**a)
        ms = time_ms(torch, run)
        b_ms, b_by = held_bound(name, a, run())
        extra[name] = dict(tables_shape=str(shape), tables_ms=ms,
                           tables_bound_ms=b_ms, tables_bound_by=b_by)
        say(f"  {name} at phase 9's largest shape {shape}: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)")
    held.largest.clear()
    return extra


def phase_times(torch, data, model, main_counts, errs, dist_state,
                lm_counts, serving, tables, seed):
    import repro_torch.core as T
    from repro_torch.kernels.binning import bin_readout_cuda
    from repro_torch.kernels.binning.ops import _beta_to_layout
    from repro_torch.kernels.featurize import featurize_cuda, featurize_ref
    from repro_torch.core.wlsh import TableIndex, build_blocked_layout
    say("== phase 5: times at the counted runs' shapes")
    # phase 9's launches, its HeldToPlain, (c)'s times; phase 3's layout s
    tables_counts, held, ex, kept, layout_s = tables
    x, _, xq = data
    lsh, ts = model.lsh, model.table_size
    n, d, m = x.shape[0], x.shape[1], lsh.m
    lsh_d, beta_d, dist_counts, dist_shapes = dist_state
    launches, tally = merged_tallies(
        [main_counts] + [(dist_counts[p], dist_shapes[p])
                         for p in sorted(dist_counts)] + [lm_counts,
                                                          serving["counts"]])
    say(f"  launches over the counted runs (phase 3, phase 6 (a), (b), (c), "
        f"phase 7, phase 8's predictor with its graphs' replays): "
        f"{launches}; phase 8's lifecycle, counted apart: "
        f"{ {k: v for k, v in serving['lifecycle_counts'][0].items() if v} }")
    rows = {}

    run = lambda: featurize_cuda(x, *lsh, f=T.RECT, table_size=ts)
    feats = run()
    ms = time_ms(torch, run)
    plain = time_ms(torch, lambda: featurize_ref(x, *lsh, f=T.RECT,
                                                 table_size=ts),
                    reps=1, warmup=False)
    rows["featurize"] = (ms, plain, bound(nbytes(x, *lsh, *feats),
                                          5.0 * m * n * d), None)
    # B1 at every shape the counted runs launched it at: the points and
    # the query batches
    feat_timed = {}
    for key in tally["featurize"]:
        src = x if key[0] == n else xq[:key[0]]
        if tuple(src.shape) + (m,) != key:
            fail(f"featurize launched at (n, d, m) = {key}, not a shape "
                 f"of phase 3's data")
        fb = featurize_cuda(src, *lsh, f=T.RECT, table_size=ts)
        b_b, _ = bound(nbytes(src, *lsh, *fb), 5.0 * m * key[0] * d)
        floor = b1_floor(torch, m, key[0], d)
        run_b = lambda: featurize_cuda(src, *lsh, f=T.RECT, table_size=ts)
        entry = dict(ms=time_ms(torch, run_b), bound_ms=b_b)
        if key[0] <= SERVE["max_batch"]:
            # a bucket of phase 8: events over launches back to back time
            # the host's launch; the profiler gives the kernel's own time
            entry["device_ms"] = device_ms(torch, run_b)
        feat_timed[key] = entry
        say(f"  featurize at n={key[0]}: {entry['ms']:.4f} ms" + (
            f" (device {entry['device_ms']:.4f} ms by torch.profiler)"
            if entry.get("device_ms") is not None else "") + "; byte bound "
            f"{b_b:.4f} ms, instruction floor " + (
                "not measured" if floor is None else
                f"{floor[0]:.4f} ms ({floor[1]:.2f} per element)")
            + f"; {tally['featurize'][key]} of its {launches['featurize']} "
            f"launches")
        del fb
    floor = b1_floor(torch, m, n, d)
    if floor is not None:
        say(f"  B1 fast path per element (rect, SASS): {floor[1]:.2f} "
            f"instructions; by opcode per loop turn: "
            + ", ".join(f"{k} {v}" for k, v in floor[2].most_common()))
    by_shape = {"featurize": by_shape_entries(
        tally["featurize"], feat_timed,
        lambda k: f"n={k[0]} d={k[1]} m={k[2]}")}
    slot, coeff = feats[4], feats[5]
    del feats
    lay = build_blocked_layout(slot, coeff, ts)
    idx = TableIndex(slot=slot, sign=coeff, weight=coeff, coeff=coeff,
                     table_size=ts, blocked=lay)
    row, totals, b2 = matvec_times(torch, idx, model.beta,
                                   "at phase 3's layout")
    rows["bin_fused_matvec"] = row
    extra_b2 = dict(b2)
    if kept is not None:
        kept_idx, kept_beta, kept_name, kept_skew = kept
        row_kept, _, b2_kept = matvec_times(torch, kept_idx, kept_beta,
                                            f"at {kept_name}'s layout")
        b2_kept.update(ms=row_kept[0], bound_ms=row_kept[2][0])
        say(f"  {kept_name}'s skew (phase 9): distinct slots an instance "
            f"min/median/max {kept_skew['distinct']}, points on its "
            f"largest slot {kept_skew['largest']}")
        extra_b2.update({f"{kept_name}_{k}": v for k, v in b2_kept.items()})
        extra_b2.update({f"{kept_name}_skew_{k}": v
                         for k, v in kept_skew.items()})
        del kept_idx, kept_beta
    del kept
    say(f"  the exact estimator at these points (phase 9 (c); "
        f"{card_line()}): exact_matvec {ex['exact_ms']:.4f} ms beside the "
        f"whole table matvec op {b2['op_ms']:.4f} ms and B2 "
        f"{row[0]:.4f} ms; build_exact_index {ex['index_ms']:.4f} ms beside "
        f"the table index's layout {1e3 * layout_s:.4f} ms (phase 3)")
    beta_lay = _beta_to_layout(lay, model.beta)
    b3_timed = {}
    row, b3 = b3_times(torch, lay, lay.coeff_lay * beta_lay,
                       "at phase 3's shape")
    rows["bin_scatter_blocked"] = row
    b3_timed[tuple(lay.slot_lay.shape) + (1,)] = b3
    del beta_lay
    torch.cuda.empty_cache()

    # the readout at every shape the counted runs launched it at: predict's
    # query batches (mean) and the distributed step's points (sum)
    ro_timed = {}
    for key in sorted(tally["bin_readout"]):
        km, kn, kb, kk = key
        if key == (m, n, totals.shape[1], 1):
            # the matvec op's: B2's run totals read through inv_pos
            _, ro_timed[key] = readout_times(torch, lay.inv_pos, coeff,
                                             totals, True)
            continue
        if (km, kb, kk) != (m, ts, 1) or (
                kn != n and not 1 <= kn <= xq.shape[0]):
            fail(f"readout launched at (m, n, B, k) = {key}, not a shape "
                 f"of phase 3's data")
        if kn == n:
            row, ro_timed[key] = readout_times(torch, slot, coeff,
                                               model.tables, False)
        else:
            qf = featurize_cuda(xq[:kn], *lsh, f=T.RECT, table_size=ts)
            row, ro_timed[key] = readout_times(torch, qf[4], qf[5],
                                               model.tables, True)
            if kn <= SERVE["max_batch"]:     # a bucket of phase 8
                dev_ms = device_ms(torch, lambda: bin_readout_cuda(
                    qf[4], qf[5], model.tables))
                ro_timed[key]["device_ms"] = dev_ms
                say(f"  readout at phase 8's bucket n={kn}: device "
                    + ("not measured" if dev_ms is None else
                       f"{dev_ms:.4f} ms") + " by torch.profiler")
            del qf
            if kn == MAIN["batch"]:
                rows["bin_readout"] = row
        torch.cuda.empty_cache()
    if "bin_readout" not in rows:
        fail("the readout was not launched at predict's batch shape")
    by_shape["bin_readout"] = by_shape_entries(
        tally["bin_readout"], ro_timed,
        lambda k: f"m={k[0]} n={k[1]} B={k[2]} k={k[3]}")
    del slot, coeff, lay, idx, totals
    torch.cuda.empty_cache()

    dist_rows, pack_timed, b3_split, extra = dist_times(torch, x, lsh_d,
                                                        beta_d, ts)
    extra.setdefault("bin_fused_matvec", {}).update(extra_b2)
    rows.update(dist_rows)
    b3_timed.update(b3_split)
    by_shape["bin_scatter_blocked"] = by_shape_entries(
        tally["bin_scatter_blocked"], b3_timed,
        lambda k: f"m={k[0]} L={k[1]} k={k[2]}")
    by_shape["route_pack"] = by_shape_entries(
        tally["route_pack"], pack_timed,
        lambda k: f"m={k[0]} L={k[1]} k={k[2]} cells={k[3]} {k[4]} out")
    torch.cuda.empty_cache()
    rows["flash_decode"] = decode_times(torch, data[0].device, seed)[0]
    by_shape["flash_decode"] = by_shape_entries(
        tally["flash_decode"], decode_serve_times(
            torch, data[0].device, seed, tally["flash_decode"]),
        lambda k: "B={} T={} KV={} G={} D={} {}".format(*k))
    decode_long_times(torch, data[0].device, seed)
    serve_graph_times(torch, serving)
    for name in SERVE_KERNELS:
        extra.setdefault(name, {})["graph_launches"] = sum(
            g["launches"].get(name, 0) * g["replays"]
            for g in serving["graphs"].values())
    for name, k in serving["lifecycle_counts"][0].items():
        if k and name in rows:
            extra.setdefault(name, {})["lifecycle_launches"] = k
    for name, k in tables_counts.items():
        if k:
            launches[name] += k
            extra.setdefault(name, {})["tables_launches"] = k
    for name, times in held_times(torch, held).items():
        extra.setdefault(name, {}).update(times)
    entries = []
    for name, (ms, plain, (b_ms, b_by), lib) in rows.items():
        src, replaces = KERNELS[name]
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=errs[name], ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        if name in by_shape:
            entries[-1]["by_shape"] = by_shape[name]
        entries[-1].update(extra.get(name, {}))
        say(f"  {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, library "
            f"{'-' if lib is None else f'{lib:.4f} ms'}; {launches[name]} "
            f"launches")
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
    model, counts, main_phases, main_pred = phase_main(torch, data,
                                                       args.seed)
    phase_small(torch, dev, args.seed)
    dist_state = phase_distributed(torch, data, args.seed, main_pred)
    del main_pred
    lm_counts = phase_lm(torch, dev, args.seed)
    serving = phase_serving(torch, data, model, args.seed)
    tables = phase_tables(torch, data, model, args.seed) + (
        main_phases["layout"],)
    entries = phase_times(torch, data, model, counts, errs, dist_state,
                          lm_counts, serving, tables, args.seed)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
