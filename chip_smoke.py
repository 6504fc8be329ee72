#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: WLSH-KRR fit,
predict and the distributed step, LM serving, KRR serving, the paper's
Tables 1 and 2, sharded KRR serving, LM training, LM serving of the
MoE, Mamba2, RWKV6, shared-attention and encoder-decoder archs, every
slot kind served on (data, model) grids of ranks, the LM train step on
such grids, the dry run, and the port's examples.

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
   D 96, f32) and command-r-plus-104b (KV 8, G 12, D 128, bf16), one
   long gemma3-1b cache (B 1, T 8191: more splits than a cluster), and
   the other slots' shapes, each in f32 and bf16: zamba2-7b's shared
   attention (KV 32, G 1, D 112), mixtral-8x22b (KV 8, G 6, D 128),
   whisper-large-v3's self-attention (KV 20, G 1, D 64) and
   cross-attention (T 1500), llama-3.2-vision-90b's cross-attention (KV
   8, G 8, D 128, T 1024) and llama4-scout-17b-a16e (KV 8, G 5, D 128),
   and one rank's heads on phase 13's grids: gemma3-1b at model 2 (KV 1,
   G 2, D 256) and qwen3-14b at model 4 (KV 2, G 5, D 128), and on phase
   14's: mixtral-8x22b at model 4 (KV 2, G 6, D 128), zamba2-7b's shared
   attention (KV 16, G 1, D 112) and whisper's self and cross attention
   (KV 10, G 1, D 64; T 452 and 1500) at model 2;
   each with random lengths, one valid row, a wrapped ring and no valid
   row, T not a multiple of the tile: 1e-5 of max|out| (f32), 1e-4
   (bf16); and at phase 7's two shapes (T 512 and 2112) and the long
   cache, each called twice in a row and on two streams.
3. Main phase: ``wlsh_krr_fit`` then ``wlsh_krr_predict`` at the repo's
   ``wlsh_krr`` config (``repro_torch.configs.wlsh_krr``, whose sizes
   phases 2, 3 and 6 read: n = 2^22, d = 64, m = 64, B = 2^23, rect,
   Gamma(2, 1), lam = 1, no preconditioner, 32 PCG iterations as the
   config's fixed-iteration step, the bf16 wire of phase 6 (c)), then 2^20
   queries in batches of 2^18.
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
10. Sharded KRR serving of phase 3's model through ``repro_torch.serve.
   ShardedPredictor`` (piece grids; rank 0 fronts, every rank its piece).
   (a) A 1x1 grid (the 2 GiB export with 16 golden queries) on phase 6's
   one-rank NCCL group (phase 6 keeps it; it is destroyed after this
   phase), in each route (broadcast, then dedup): counts reset, then
   load, warmup of the 11 buckets, a request at every bucket's size and
   the golden block while ``HeldToPlain`` holds B1, the readout and B8
   against their plain versions at each new shape, then phase 8's 8192
   single-row requests through ``MicroBatcher``; counts read: B1 and the
   readout must launch, B8 in the dedup route only.  Every answer must be
   bitwise equal to phase 8's ``Predictor`` on the same rows, repeats
   equal their first answer, the golden block within its tol.  By bucket
   the sharded ``predict()`` µs beside phase 8's graph warm path and
   eager path; at buckets 1 and 1024 its device busy time by kernel and
   its host self time by operator (torch.profiler); B8 at every shape the
   dedup route launched it at, by torch.profiler, in turns with its first
   design (``sharded_device_ms`` in the ``kernels`` line).  Then a lifecycle of
   1x1 grids of phase 8's lifecycle models: v1 served, v2 with its piece
   scaled on disk (canary reject), v3 pieces without a manifest
   (invisible), v4 a piece of the previous export (refused at load), v5
   swapped in, ``rollback()`` to v1, whose answers must be
   ``wlsh_krr_predict``'s bits (counted apart).  (b) A 2x2 grid: the
   model exported as four 512 MiB pieces, four processes spawned on the
   one card over gloo (named: NCCL refuses two ranks on one device), each
   loading its piece and holding its launches against the plain versions;
   rank 0 serves a request at every bucket's size, the golden block and
   2048 batcher requests, within 1e-5 of max|pred| of phase 8's
   ``Predictor`` (repeats bitwise their first answer).  Its times are of
   ranks sharing one card over host-staged collectives.  Each export's
   directory goes when its part ends, after a check of free disk.  The
   phase's launches join the ``kernels`` line's (``sharded_launches``).
11. LM training: gemma3-1b at its full config (26 layers, d_model 1152,
   vocab 262144; about 1.0 B parameters) through ``launch/train.py``'s
   ``build`` (``make_train_step``: bf16 compute, float32 master parameters
   and AdamW state, remat per slot and per cross-entropy chunk) in
   ``RestartableLoop``: batch 8 x 2048 from ``synthetic_lm_batch``, 6
   steps, a checkpoint (12 GB, into a temporary directory removed after)
   every 3, a failure injected at step 5.  Before it, the bf16 logits
   product with a float32 result (``torch.mm``'s out_dtype and the
   backward written for it) against the float32 product (logits 1e-5 of
   max, gradients within one bf16 rounding, 2^-8, as the JAX package's
   transpose rounds them), and one f32 step of the smoke config on the
   card against the CPU's to the CPU tests' limits.  Counts reset before
   the loop and read after (``train_launches``, 0 for every kernel:
   training attends over the full sequence).  The loop must restart once
   and the replayed steps' losses equal the first run's within 1e-3
   relative; every loss and grad norm finite.  Then the 2-microbatch step
   against the full one, in bf16 and float32: from the run's state, read
   only (its std-1 stacked weights make attention near one-hot, and the
   grad norm moves by percents between the two even in float32), and
   from weights drawn at std 1/sqrt(fan-in), loss and grad norm within
   1e-3 relative; one step profiled by kind of kernel and its optimizer
   share.  Printed: the loss and grad-norm curve, ms a step (wall, and
   device by CUDA events around the step), tokens/s, MFU against the
   dense bf16 peak with its FLOP count, peak device memory against its
   reckoning, the checkpoint's write and read seconds
   (``io_checkpoint_*_us``) and the loop's time outside its steps.
12. LM serving of the other slot kinds at full width, f32, random weights
   from the seed, each arch's freed before the next, through
   ``repro_torch.launch.serve.generate`` (64 greedy tokens, batch 8):
   zamba2-7b (all 81 layers: mamba2 slots and the shared windowed
   attention every third; a 2048-token prompt), rwkv6-1.6b (all 24
   layers; 2048), mixtral-8x22b at full width and 2 of its 56 layers
   (capacity factor 1.25 as configured; 4096, so the 4096-row window ring
   wraps at the first decode step) and whisper-large-v3 (32 encoder and
   32 decoder layers over 1500 frames from the seed; 448).  Counts are
   reset before each serve run and read after: B9 must launch 27, 0, 2
   and 64 times a decode step (attention, shared-attention and
   cross-attention layers).  Printed: parameters, prefill ms, tokens/s
   and model-FLOP share of the f32 peak (``launch.specs.useful_flops``),
   decode ms a step and tok/s, peak device memory against weights and
   caches, mixtral's dropped (token, expert) pairs.  Then, with the
   weights rescaled in place to std 1/sqrt(fan-in)
   (``testing.train.fan_in_factors``), prefill/decode consistency within
   2e-3 of max|reference|: rwkv6 and whisper (its frames the same) one
   decode step after prefill(x[:S]) against prefill(x[:S+1]); zamba2
   prefill(x[:192]) and 64 decode steps against prefill(x[:256]) (each
   within one 256-token SSD chunk: a prefill past one chunk ends on a
   chunk's edge, so a check across chunks takes 256 decode steps),
   logits, conv and ssm states and the shared attention's rows; mixtral
   at batch 2, a 1024-token prompt and capacity factor 8.0.  Its launches
   are listed apart in the ``kernels`` line (``lm_slots_launches``).
13. The dense LMs served on (data, model) grids of ranks
   (``repro_torch.models.sharded``: the JAX package's sharding rules,
   column- and row-parallel products, the vocab-parallel table, the FSDP
   and head_dim gathers), f32, random weights from the seed rescaled to
   std 1/sqrt(fan-in).  Each grid's reference is the one-process port on
   the card on the same weights, run first, its logits moved to the host
   and its memory freed before the grid starts; the grids restore each
   rank's blocks with ``restore_resharded`` by ``param_shardings`` from one
   checkpoint a model, written once into a temporary directory (10 GiB
   free needed).  (a) phase 7's run (gemma3-1b uncut, batch 8, a
   2048-token prompt, 64 tokens) on a 1x1 grid over NCCL through
   ``generate(mesh=)``: tokens equal the reference's, logits within 1e-5
   of max|logit| (whether bitwise printed), B9 26 times a decode step;
   collectives of the run, and of one prefill and one decode step, by
   kind.  (c) gemma3-1b uncut on a 2x2 grid and (b) qwen3-14b at full
   width cut to 2 of its 40 layers on a 1x4 grid, each four processes
   spawned on the one card over gloo (NCCL refuses two ranks on one
   device; their times are of ranks sharing one card, not of a grid):
   batch 8 (4 a data rank), a 512-token prompt, 2 decode steps (c), and
   batch 4, 512, 4 steps (b), the steps fed the reference's greedy
   tokens; every step's logits within 2e-3 of max|logit| on every rank,
   each rank's parameter bytes equal to ``launch.specs.shard_bytes``, B9
   launched layers x steps on every rank at the local (B 4, KV 1, G 2, D
   256) and (B 4, KV 2, G 5, D 128).  Printed for each grid: prefill ms,
   decode ms a step, peak device memory a rank, collective calls and
   bytes a step by kind.  Its launches are listed apart in the
   ``kernels`` line (``mesh_launches``).
14. The other slot kinds served on (data, model) grids of ranks
   (``models.sharded``: experts, ``ssm_heads`` and rwkv6's heads on
   'model', the shared block and the encoder gathered at use, cross
   attention on the rank's kv heads), as phase 13's (b) and (c): f32
   weights from the seed at std 1/sqrt(fan-in), the one-process reference
   first, one checkpoint a model (free disk checked before each: mixtral's
   layer is 11.8 GB), four processes on the card over gloo fed the
   reference's greedy tokens, batch 4.  (a) mixtral-8x22b, 1 of its 56
   layers, on 1x4 (2 experts a rank), a 512-token prompt, 2 decode steps:
   the prefill's kept MoE pairs equal on the model ranks and to the
   reference's; (b) zamba2-7b, 6 of its 81 layers (2 periods, the shared
   block applied twice), on 2x2 (56 ssm heads a rank, FSDP over
   'data'), 512, 2; (c) rwkv6-1.6b, 8 of its 24 layers, on 1x4 (8 heads
   a rank), 512, 4; (d) whisper-large-v3, 8 of its 32 decoder and 8 of
   its 32 encoder layers, on 2x2 (the encoder over 1500 frames from the
   seed, 10 heads a rank, the vocab split), a 448-token prompt, 2
   steps.  Every step's logits within 2e-3 of max|logit| on every rank,
   parameter bytes a rank ``shard_bytes``', B9 layers x steps a rank at
   the local (B 4, KV 2, G 6, D 128), (B 2, KV 16, G 1, D 112), none, and
   (B 2, KV 10, G 1, D 64).  Printed as phase 13's.  Its launches are
   listed apart in the ``kernels`` line (``slot_grids_launches``).
15. The LM train step on (data, model) grids of ranks
   (``launch.steps.make_train_step(mesh=)``: the collectives autograd
   sees, the vocab-parallel cross-entropy, the group checkpoints keeping
   the rank's sequence block, AdamW on each rank's blocks with the global
   norm counted once a block), each against the one-process train step on
   the card, run first.  (a) gemma3-1b uncut on a 1x1 grid over NCCL at
   phase 11's batch (8 x 2048, bf16 compute, float32 master weights and
   AdamW state, the init's draws, ``init_train_state(mesh=)`` equal to the
   one-process draw): 3 steps from one state, loss and grad norm within
   1e-4 relative at every step (whether bitwise printed), the parameters
   after step 1 within lr x 1e-3 of the one-process update where |g| >
   1e-5.  (b) gemma3-1b at full width cut to 6 of its 26 layers (five
   local and one global, its pattern's first period) on a 2x2 grid, four
   processes spawned on the one card over gloo (their times are of ranks
   sharing one card, not of a grid): f32, weights from the seed at std
   1/sqrt(fan-in), batch 4 x 512, 1 step, each rank's train state restored
   by ``restore_resharded`` with ``param_shardings`` and ``opt_shardings``
   from one checkpoint of the one-process state (12 GiB free needed): loss within 1e-5 and grad norm
   within 1e-4 relative, every rank's gradient blocks within 1e-4 of the
   leaf's max|g|, its parameters after step 1 by (a)'s rule, the train
   state bytes a rank holds equal to ``shard_bytes``' params + opt_state.
   Printed: ms a step beside the one-process step's, tokens/s, MFU
   (``launch.specs.useful_flops``), peak device memory against
   ``shard_bytes``, collectives a step by kind, the kernels' launches
   (none: listed as ``mesh_train_launches`` in the ``kernels`` line).
5. Times, run last: B1-B3 and the readout at the main phase's shapes,
   B5-B8 at phase 6's and B9 at the decode_32k shape (T = 32768; the
   gemma3-1b global layer in f32 and bf16, qwen3-14b in bf16), each kernel
   (CUDA events), its plain version, its bound from bytes and operations,
   and one PyTorch library call computing the same function where there
   is one (scaled_dot_product_attention for B9).  B3's bound counts the
   tiles' ranges it reads, not the layout's slack.  B5 and B7 also
   against their first designs (kept for that), B5 split into its kernels
   by torch.profiler, the zero fill of B7's send buffer alone (the
   index_add_ yardstick leaves it out).  B8 first on the inputs of
   ``repro_torch.testing.route_cases`` (random, negative and descending
   cells, sentinels at num_cells and 2^31 - 1, L 1, 3, 5 and 4097, k 1, 3
   and 4 (and a one-column back), m 1 and 65, with and without a
   coefficient, rows aligned and one element off), it and its first
   design bitwise the plain version, and on this routing with every row
   reversed and with its cells randomly permuted; then, in both forms (with its coefficient, and without it:
   the sharded dedup route), in turns with its first design (kept for
   that), torch.gather (times coeff: its function in two calls; without
   the coefficient the same function, held bitwise) and the streams
   alone (a PyTorch copy, or multiply, of the same cell, coeff and out
   bytes, no back read) and B8 with every real cell moved to cell 0 (its
   streams with the back reads on one line), each form beside its bound,
   with the routing's share of sentinel positions; and without the
   coefficient on the routing's cells reversed and randomly permuted, in
   turns with its first design.  The
   readout against its first design (B4's gather kernel, then the PyTorch
   combine; in turns), at one instance a launch and all in one, beside its
   32-byte-sector floor.  B2 as the matvec op runs it (the run totals)
   at phase 3's layout and at forest's (phase 9), each in turns with its
   first design (kept for that; beta laid out beforehand), beside beta
   gathered through src alone; the whole matvec op there in turns with
   the parent's op (beta laid out, B2's first design, the map back, the
   mean), with its peak extra allocation.  B1 beside its SASS
   instruction floor, B9 at
   phase 7's shapes over six turns in turns with
   scaled_dot_product_attention on the same cache
   (``library_device_ms``), and B9 on one long cache (B 1, T
   32768, f32 and bf16) at its plan (splits combined by the last block)
   against the same kernel with its splits capped at a cluster's.  Each
   wrapper also counts its launches by input shape; a kernel's
   ``launches`` are summed over the counted runs (phase 3, phase 6 (a),
   (b) and (c), phase 7, phase 8 with its graphs' replays, phase 9 (a)
   and (b), phase 10 (a) and (b)), and B1, B3, the readout (phase 6 (c)'s
   combine too), B7 and B9 are timed at every shape the runs before
   phase 9 launched them at (for B1 and the readout also
   phase 8's eleven bucket shapes, where the kernel's own time comes from
   torch.profiler as ``device_ms``: events over launches back to back
   time the host there), listed with those launches as ``by_shape`` (B9's
   device time from torch.profiler); B1, B2, B3, B5 and the readout also
   at phase 9's largest shape (``tables_ms``; B3's beside index_add_ on
   the same inputs, forest's layout, ``tables_library_ms``).  Phase 11's
   counted run is listed as ``train_launches``, phase 12's as
   ``lm_slots_launches``, phase 13's as ``mesh_launches``, phase 14's as
   ``slot_grids_launches``, phase 15's as ``mesh_train_launches``, phase
   17's as ``examples_launches``; B9 at
   every shape phases 12, 13 and 14
   launched it at, by torch.profiler beside scaled_dot_product_attention
   on the same cache (``lm_slots_by_shape``, ``mesh_by_shape``,
   ``slot_grids_by_shape``).  Last, one replay of each of phase 8's
   graphs: by CUDA events back to back, and its kernels' device time by
   torch.profiler over the warm path's wall (the device-busy share).
16. The dry run (``repro_torch.launch.dryrun``: rank 0 of the fake 16x16
   and 2x16x16 grids on meta tensors, counted by ``repro_torch.roofline``),
   run last.  (a) ``python -m repro_torch.launch.dryrun`` over the cells of
   ``--mesh both --cells all`` and of ``--cells krr --krr-variant
   hashjoin``, one subprocess a (mesh, arch) and a (mesh, KRR variant),
   run with (b)'s dry runs ``DRYRUN_LANES`` at a time from before phase
   1's build (they need no card, and take the cores the earlier phases
   leave idle); the phase waits for any still going after (b)'s and (c)'s
   runs on the card: every process must exit 0 with one line a cell; a compact
   line a cell is printed.  (b) Three runs of the
   earlier phases, each on the card on a one-rank NCCL grid under the
   tracer, against its dry run on a fake 1x1 grid in a subprocess (the fake
   group cannot live beside NCCL): phase 15 (a)'s gemma3-1b train step (8
   x 2048, bf16 compute, float32 master weights and AdamW state), phase
   7's gemma3-1b decode step (f32, batch 8, cache 2112, B9 on each
   attention layer) and phase 6's psum step at the ``wlsh_krr`` config
   (n 2^22, m 64, B 2^23; B1, B2, B3 and the readout).  Their FLOPs, HBM
   bytes, collective calls and bytes, kernel credits and host reads must
   be equal, and the dry run's arguments plus peak within
   ``DRYRUN_PEAK_BAND`` of the arguments plus the growth of
   ``max_memory_allocated`` on the card.  (c) The fused matvec op at phase
   3's shapes under the tracer on the card: B2 and the readout credited,
   no (64, 2^23) float32 tensor made.

17. The port's five examples (``examples/torch_*.py``) on the card, as a
   user runs them.  ``torch_distributed_krr.py`` (``krr_train`` on forest
   at scale 0.002, m 64, 40 CG iterations, one rank over NCCL) and
   ``torch_train_lm.py`` (gemma3-1b's smoke config, batch 8 x 128, a
   checkpoint into a temporary directory; ``TRAIN_LM_ARGS`` cut its 200
   steps to 60, a checkpoint every 10, failures at steps 25 and 45) start
   first, each ``python examples/<name>.py --device cuda`` in a process of
   its own from the repository's root; meanwhile, in this process through
   their ``main(argv)``, ``torch_quickstart.py --precond nystrom --num-rhs
   9 --export DIR`` (its asserts: WLSH within 2x exact KRR's RMSE + 0.05,
   the 256-row round trip bitwise or within 1e-6, the cache replay
   bitwise), ``torch_gp_smoothness.py`` (the smooth bucket's test RMSE
   must be below rect's) and ``torch_serve_decode.py`` (500 requests;
   every batched answer within 1e-6 of max|pred| of the direct path),
   with the launch counts reset before and read after: B1, B2, B3, the
   readout and B5 must launch (``examples_launches`` in the ``kernels``
   line).  Then the two processes must exit 0: distributed_krr on one
   rank with its CG residual below 1e-6 and its test RMSE within 5e-4 of
   the 8 gloo ranks' on the CPU, train_lm restarted twice and its last
   losses below its first.  Each example's wall and numbers are printed
   beside the card's name and power limit.

Prints the card line, a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
# phase 3's queries, answered in batches; main() adds the wlsh_krr config's
# sizes (repro_torch.configs.wlsh_krr: n, d, m, B, bucket, PDF shape, lam,
# iterations, wire dtype; ``krr_sizes``), which phases 2, 3 and 6 read
MAIN = dict(n_query=1 << 20, batch=1 << 18)
PARITY_SMALL = 1 << 16     # phase 2's first n; its second is MAIN["n"]
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
# phase 12: the other slot kinds at full width (f32, seeded random weights),
# each served through repro_torch.launch.serve.generate.  ``b9`` is B9's
# launches a decode step (attention, shared-attention and cross-attention
# layers); ``check`` the prefill/decode consistency check's (batch, prompt,
# decode steps).  mixtral-8x22b keeps 2 of its 56 layers (an 8-expert layer
# is 2.5 B parameters, 10 GB in float32); its check runs at capacity factor
# 8.0, so that no pair is dropped in either run.
LM_SLOTS = (
    dict(arch="zamba2-7b", layers=None, batch=8, prompt=2048, gen=64, b9=27,
         check=(8, 192, 64)),
    dict(arch="rwkv6-1.6b", layers=None, batch=8, prompt=2048, gen=64, b9=0,
         check=(8, 2048, 1)),
    dict(arch="mixtral-8x22b", layers=2, batch=8, prompt=4096, gen=64, b9=2,
         check=(2, 1024, 1)),
    dict(arch="whisper-large-v3", layers=None, batch=8, prompt=448, gen=64,
         b9=64, check=(8, 448, 1)),
)
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
                 ("gemma3-1b", 1, 1, 4, 256, 8191, "bfloat16"),
                 # the kv-head shapes of the other slots: zamba2's shared
                 # attention (D 112, not a size of the bf16 mma path),
                 # mixtral's windowed GQA, whisper's self- and
                 # cross-attention (1500 source rows), llama-3.2-vision's
                 # cross-attention (1024 patches), llama4-scout
                 ("zamba2-7b shared", 8, 32, 1, 112, 2112, "float32"),
                 ("zamba2-7b shared", 4, 32, 1, 112, 777, "bfloat16"),
                 ("mixtral-8x22b", 8, 8, 6, 128, 4096, "float32"),
                 ("mixtral-8x22b", 4, 8, 6, 128, 1001, "bfloat16"),
                 ("whisper-large-v3 self", 8, 20, 1, 64, 512, "float32"),
                 ("whisper-large-v3 self", 4, 20, 1, 64, 449, "bfloat16"),
                 ("whisper-large-v3 cross", 8, 20, 1, 64, 1500, "float32"),
                 ("whisper-large-v3 cross", 8, 20, 1, 64, 1500, "bfloat16"),
                 ("llama-3.2-vision-90b cross", 8, 8, 8, 128, 1024,
                  "float32"),
                 ("llama-3.2-vision-90b cross", 8, 8, 8, 128, 1024,
                  "bfloat16"),
                 ("llama4-scout-17b-a16e", 4, 8, 5, 128, 1001, "float32"),
                 ("llama4-scout-17b-a16e", 4, 8, 5, 128, 1001, "bfloat16"),
                 # one rank's heads on phase 13's grids: gemma3-1b at model
                 # 2 (its one kv head, two query heads a rank; 516-row
                 # global caches) and qwen3-14b at model 4 (two kv heads,
                 # ten query heads a rank; 528 rows)
                 ("gemma3-1b on 2x2", 4, 1, 2, 256, 516, "float32"),
                 ("gemma3-1b on 2x2", 4, 1, 2, 256, 516, "bfloat16"),
                 ("qwen3-14b on 1x4", 4, 2, 5, 128, 528, "float32"),
                 ("qwen3-14b on 1x4", 4, 2, 5, 128, 528, "bfloat16"),
                 # one rank's heads on phase 14's grids: mixtral-8x22b at
                 # model 4 (two kv heads, twelve query heads a rank;
                 # 520-row rings), zamba2-7b's shared attention at model 2
                 # (16 heads a rank, two rows a data rank), whisper's self
                 # (452 rows) and cross attention (1500) at model 2
                 ("mixtral-8x22b on 1x4", 4, 2, 6, 128, 520, "float32"),
                 ("mixtral-8x22b on 1x4", 4, 2, 6, 128, 520, "bfloat16"),
                 ("zamba2-7b shared on 2x2", 2, 16, 1, 112, 520, "float32"),
                 ("zamba2-7b shared on 2x2", 2, 16, 1, 112, 520,
                  "bfloat16"),
                 ("whisper-large-v3 self on 2x2", 2, 10, 1, 64, 452,
                  "float32"),
                 ("whisper-large-v3 cross on 2x2", 2, 10, 1, 64, 1500,
                  "float32"),
                 ("whisper-large-v3 cross on 2x2", 2, 10, 1, 64, 1500,
                  "bfloat16"))
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


def krr_sizes(torch) -> dict:
    """The ``wlsh_krr`` config's sizes, as MAIN keys."""
    from repro_torch.configs.wlsh_krr import CONFIG
    wire = {"bf16": torch.bfloat16, "f32": torch.float32}
    return dict(n=CONFIG.n_points, d=CONFIG.dim, m=CONFIG.m,
                table_size=CONFIG.table_size, lam=CONFIG.lam,
                maxiter=CONFIG.cg_iters, bucket=CONFIG.bucket,
                pdf_shape=CONFIG.pdf_shape, wire=wire[CONFIG.wire_dtype])


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


def host_split(torch, fn, reps: int = 20, top: int = 8):
    """The host's time in one fn() call by operator, in us: the ``top``
    operators by self CPU time from torch.profiler over ``reps`` calls,
    and the self CPU time of all of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_cpu_time_total / reps)
                  for e in prof.key_averages()), key=lambda kv: -kv[1])
    return ops[:top], sum(t for _, t in ops)


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


def check_unpack_adversarial(torch, dev):
    """B8 and its first design bitwise (signed zeros apart) against the
    plain version, and the plain version against the numpy oracle, on the
    inputs of ``repro_torch.testing.route_cases``: random, negative and
    descending cells, sentinels at num_cells and 2^31 - 1, at every L, k,
    m of it, with and without a coefficient, aligned and one element
    off."""
    from repro_torch.kernels.binning import route_unpack_cuda, route_unpack_ref
    from repro_torch.kernels.binning.variants import route_unpack_v1_cuda
    from repro_torch.testing.route_cases import (UNPACK_KS, UNPACK_LS,
                                                 UNPACK_MS, unpack_bits,
                                                 unpack_case, unpack_oracle)
    cases = 0
    for L, k, m, coeff, offset in itertools.product(
            UNPACK_LS, UNPACK_KS, UNPACK_MS, (True, False), (False, True)):
        what = f"L={L} k={k} m={m} coeff={coeff} offset={offset}"
        cell, cf, back = unpack_case(100 + L + k, m, L, k, coeff=coeff,
                                     offset=offset, device=dev)
        want = unpack_bits(route_unpack_ref(cell, cf, back))
        oracle = unpack_oracle(cell.cpu().numpy(),
                               None if cf is None else cf.cpu().numpy(),
                               back.cpu().numpy())
        if not np.array_equal(want, oracle.view(np.uint32)):
            fail(f"B8's plain version at {what}: not the numpy oracle's "
                 f"bits")
        for name, fn in (("B8", route_unpack_cuda),
                         ("B8's first design", route_unpack_v1_cuda)):
            if not np.array_equal(unpack_bits(fn(cell, cf, back)), want):
                fail(f"{name} at {what}: not bitwise its plain version")
        cases += 1
    say(f"  B8 and its first design on {cases} adversarial inputs (random, "
        f"negative and descending cells, sentinels at num_cells and "
        f"2^31 - 1, L {UNPACK_LS}, k {UNPACK_KS}, m {UNPACK_MS}, with and "
        f"without coeff, rows aligned and one element off): bitwise the "
        f"plain version, itself the numpy oracle's bits")


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
    for n in (PARITY_SMALL, MAIN["n"]):
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
    pdf = T.GammaPDF(MAIN["pdf_shape"], 1.0)
    f = T.get_bucket_fn(MAIN["bucket"])
    lsh = T.sample_lsh_params(np.random.default_rng(seed), MAIN["m"],
                              MAIN["d"], pdf, device=x.device)
    spec = T.WLSHKernelSpec(bucket=f, pdf=pdf)
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
    feats = featurize_ref(xq[:nq], *model.lsh, f=f,
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
                              SMALL["lengthscale"], device="cpu")
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
    f, wire = T.get_bucket_fn(MAIN["bucket"]), MAIN["wire"]
    lsh = T.sample_lsh_params(np.random.default_rng(seed), MAIN["m"],
                              MAIN["d"], T.GammaPDF(MAIN["pdf_shape"], 1.0),
                              device=dev)
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
    step_a = D.make_krr_step(mesh, cfg_a, f)
    predict_a = D.make_krr_predict(mesh, cfg_a, f)

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
        **base, fused=False, blocked_split=False), f)
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
            mesh, cfg_c, f, x, y, lsh, payload_dtype=wire)
        for dedup in (True, False):
            pred_hj[dedup] = D.make_krr_predict_hashjoin(
                mesh, cfg_c, f, payload_dtype=wire,
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
    step_c = D.make_krr_step_hashjoin(mesh, cfg_c, f, payload_dtype=wire)
    run("hj-bf16", "hash-join step (bf16 wire, as in (c))",
        lambda: step_c(x, y, lsh))
    say(f"      step split ms: {split(step_c)}")
    step_hj = D.make_krr_step_hashjoin(mesh, cfg_c, f,
                                       payload_dtype=torch.float32)
    beta_hj, _, _, stats_hj = run("hj-f32", "hash-join step (f32 wire)",
                                  lambda: step_hj(x, y, lsh))
    say(f"      step split ms: {split(step_hj)}; StepStats "
        f"{int(stats_hj.overflow_dropped)}, {int(stats_hj.wire_nonfinite)}")
    step_f = D.make_krr_step(mesh, cfg_c, f)
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
    # the group stays: phase 10 serves on it, then leaves it
    return lsh, beta_a, counts, shapes


def dist_times(torch, x, lsh, beta, ts):
    """B5-B8 at phase 6's shapes (n = 2^22, one rank's routing), with
    their plain versions and library calls; B5 and B7 also against their
    first designs, B5 split by the profiler into its kernels, B7's zero
    fill of the send buffer alone, B8 against torch.gather times coeff (two
    calls: B8's function) and without its coefficient against
    torch.gather, and B3 at path (a)'s split layout.  Returns the
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
                                                      route_pack_v1_cuda,
                                                      route_unpack_v1_cuda)
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

    # B8: the adversarial inputs first, then both forms, each in turns
    # with its first design, torch.gather (times coeff: B8's function in
    # two calls), the streams alone (PyTorch passes over the same cell,
    # coeff and out bytes that read no back value) and B8 with every real
    # cell moved to cell 0 (the same streams, the back reads all on one
    # line: what the back reads cost); then without the coefficient on
    # the routing's cells in other orders (each row reversed, a random
    # permutation), in turns with its first design
    check_unpack_adversarial(torch, x.device)
    orders = dict(reversed=cell_lay.flip(1).contiguous(),
                  permuted=cell_lay.view(-1)[torch.randperm(
                      cell_lay.numel(), device=x.device)].view(
                          cell_lay.shape))
    for what, cl in orders.items():
        if not torch.equal(route_unpack_cuda(cl, lay.coeff_lay, send).view(
                torch.int32), route_unpack_ref(cl, lay.coeff_lay, send).view(
                torch.int32)):
            fail(f"B8 on phase 5's routing, cells {what}: not bitwise")
    order_ms = {what: event_turns(torch, dict(
        new=lambda cl=cl: route_unpack_cuda(cl, None, send),
        first=lambda cl=cl: route_unpack_v1_cuda(cl, None, send)))
        for what, cl in orders.items()}
    del orders
    one_cell = torch.where(cell_lay < nb, 0, cell_lay)
    sentinel = float((cell_lay >= nb).float().mean())
    idx = cell_lay.long()
    back = torch.cat([send, send.new_zeros(int(idx.max()) + 1 - nb)])
    gather = lambda: torch.gather(back.expand(m, -1), 1, idx)
    bits = cell_lay.view(torch.float32)
    sink = torch.empty_like(bits)
    b8 = {}
    for form, cf in (("coeff", lay.coeff_lay), ("bare", None)):
        new = lambda cf=cf: route_unpack_cuda(cell_lay, cf, send)
        out = new()
        if not torch.equal(route_unpack_v1_cuda(cell_lay, cf, send), out):
            fail(f"B8's first design ({form}) differs from B8")
        if cf is None and not torch.equal(out, gather()):
            fail("B8 without a coefficient differs from torch.gather")
        fns = dict(
            new=new,
            first=lambda cf=cf: route_unpack_v1_cuda(cell_lay, cf, send),
            library=gather if cf is None else
            lambda: gather() * lay.coeff_lay,
            streams=(lambda: sink.copy_(bits)) if cf is None else
            lambda: torch.mul(bits, lay.coeff_lay, out=sink),
            one_cell=lambda cf=cf: route_unpack_cuda(one_cell, cf, send))
        b8[form] = event_turns(torch, fns)
        b8[form]["bound"] = bound(nbytes(cell_lay, out) + 4 * distinct
                                  + (0 if cf is None else
                                     nbytes(lay.coeff_lay)))[0]
        del out
    del sink, bits, one_cell
    plain = time_ms(torch, lambda: route_unpack_ref(cell_lay, lay.coeff_lay,
                                                    send),
                    reps=1, warmup=False)
    lib = b8["bare"]["library"]
    rows["route_unpack"] = (b8["coeff"]["new"], plain,
                            (b8["coeff"]["bound"], "bytes"), lib)
    for form, what in (("coeff", "with its coefficient"),
                       ("bare", "without a coefficient (the dedup route)")):
        t = b8[form]
        say(f"  B8 route unpack {what}: {t['new']:.4f} ms (bound "
            f"{t['bound']:.4f} ms, {t['bound'] / t['new']:.1%} of it); "
            f"first design {t['first']:.4f} ms; torch.gather"
            + (" alone" if form == "bare" else " times coeff (two calls)")
            + f" {t['library']:.4f} ms; the streams alone (no back read) "
            f"{t['streams']:.4f} ms; B8 with every real cell on cell 0 "
            f"{t['one_cell']:.4f} ms; in turns, CUDA events")
    say("  B8 without a coefficient on the routing's cells in other orders, "
        "new / first design: " + ", ".join(
            f"{what} {t['new']:.4f} / {t['first']:.4f} ms"
            for what, t in order_ms.items()))
    say(f"  B8 at phase 5's routing: {sentinel:.1%} of the positions on the "
        f"sentinel; bitwise its plain version, its first design and, "
        f"without a coefficient, torch.gather ({card_line()})")
    say("  (library calls: index_add_ for B5 and B7, torch.gather for B6 "
        "and B8 -- B8's without the coeff product)")
    del idx, back, send, cell_lay
    torch.cuda.empty_cache()
    # B3 last, so B5-B8 are timed as before it was added here
    _, b3 = b3_times(torch, lay, lay.coeff_lay * layout_rows(lay, beta),
                     "at path (a)'s split layout")
    b3_split = {tuple(lay.slot_lay.shape) + (1,): b3}
    return rows, pack_timed, b3_split, {
        "route_unpack": dict(
            gather_coeff_ms=b8["coeff"]["library"],
            first_design_ms=b8["coeff"]["first"],
            streams_ms=b8["coeff"]["streams"],
            nocoeff_ms=b8["bare"]["new"], nocoeff_bound_ms=b8["bare"]["bound"],
            nocoeff_first_design_ms=b8["bare"]["first"],
            nocoeff_library_ms=lib, nocoeff_streams_ms=b8["bare"]["streams"],
            one_cell_ms=b8["coeff"]["one_cell"],
            nocoeff_one_cell_ms=b8["bare"]["one_cell"],
            nocoeff_reversed_ms=order_ms["reversed"]["new"],
            nocoeff_permuted_ms=order_ms["permuted"]["new"],
            nocoeff_permuted_first_design_ms=order_ms["permuted"]["first"],
            sentinel_share=sentinel)}


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
    """B9 against its plain version at the kv-head shapes of the ten
    archs' attention, shared-attention and cross-attention layers: 1e-5 of
    max|out| with an f32 cache, 1e-4 with bf16."""
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


def event_turns(torch, fns: dict, rounds: int = 2) -> dict:
    """CUDA-event times of each fn in ``fns`` (name -> fn) in alternating
    turns (the names in order, then in reverse, ``rounds`` times), each
    turn ``time_ms``'s mean of 5 calls: {name: the mean over its turns}."""
    out = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            out[name].append(time_ms(torch, fns[name]))
    return {name: sum(ts) / len(ts) for name, ts in out.items()}


def spread(ts) -> str:
    return (f"{sum(ts) / len(ts):.4f} ms (min {min(ts):.4f}, max "
            f"{max(ts):.4f}, {len(ts)} turns)" if ts else "not measured")


def decode_serve_times(torch, dev, seed, tally, label="phase 7"):
    """B9 at every shape a counted run launched it at (``tally``: its
    launches by (B, T, KV, G, D, cache dtype); phase 7's gemma3-1b: the
    global layers' caches and the local layers' rings; phase 12's: the
    windowed, shared and cross-attention caches): device time from the
    profiler over several turns, in turns with
    scaled_dot_product_attention on the same cache laid out (B, KV, T, D)
    (enable_gqa, boolean mask), against the bound, on a wrapped ring
    (every row valid, as a cross-attention source is)."""
    import torch.nn.functional as F
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
        kt, vt = (a.transpose(1, 2).contiguous() for a in (k, v))
        qs = q.reshape(b, kv * g, 1, d).to(kt.dtype)
        mask = (valid > 0)[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True)
        got = turns(torch, {"new": run, "sdpa": lib})
        b_ms, _ = bound(nbytes(q, k, v, valid, out), 4.0 * q.numel() * t)
        mean = lambda ts: sum(ts) / len(ts) if ts else None
        timed[key] = dict(device_ms=mean(got["new"]), bound_ms=b_ms,
                          library_device_ms=mean(got["sdpa"]))
        say(f"  B9 at {label}'s B={b} KV={kv} G={g} D={d} T={t} {dt}: "
            f"device {spread(got['new'])} (torch.profiler: "
            + ", ".join(names) + f"), bound {b_ms:.4f} ms, {tally[key]} "
            f"launches in {label}; turns "
            + " ".join(f"{x:.4f}" for x in got["new"])
            + f"; scaled_dot_product_attention device {spread(got['sdpa'])} "
            f"({card_line()})")
        del q, k, v, valid, out, kt, vt, qs, mask
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


def index_add_ms(torch, slot_lay, contrib, width):
    """index_add_ of the contributions (m, L) into a flat (m, width) table
    at each position's slot: B3's function in one PyTorch call."""
    m = slot_lay.shape[0]
    flat = (slot_lay.long() + width * torch.arange(
        m, device=contrib.device)[:, None]).view(-1)
    acc = torch.zeros(m * width, device=contrib.device)
    return time_ms(torch, lambda: acc.index_add_(0, flat, contrib.view(-1)))


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
    lib = index_add_ms(torch, lay.slot_lay, contrib, width)
    used = int(lay.blk_start[:, -1].sum()) * lay.block_n
    b = bound(8 * used + nbytes(lay.blk_start, tables), used)
    b_all, _ = bound(nbytes(lay.blk_start, lay.slot_lay, contrib, tables))
    say(f"  B3 {label} (m={m}, L={lay.slot_lay.shape[1]}, block_n="
        f"{lay.block_n}): {ms:.4f} ms; bound over the tiles' ranges "
        f"{b[0]:.4f} ms ({b[0] / ms:.1%} of it; the ranges are "
        f"{used / lay.slot_lay.numel():.1%} of the layout, whose whole "
        f"bytes would take {b_all:.4f} ms); plain {plain:.4f} ms, "
        f"index_add_ {lib:.4f} ms")
    del tables
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


def combine_times(torch, coeff, vals):
    """The readout without a slot (``bin_combine_op``: point i reads
    column i of the (m, n) values, summed over the instances) at (m, n):
    its time, the plain combine's, one PyTorch call for the same sum
    (``torch.linalg.vecdot`` over the instances) and the bound: coeff and
    vals read once, out written once, 2 m n operations.  Returns the
    ``by_shape`` times."""
    from repro_torch.kernels.binning import bin_readout_cuda
    from repro_torch.kernels.binning.ref import combine_ref
    m, n = coeff.shape
    run = lambda: bin_readout_cuda(None, coeff, vals, average=False)
    out = run()
    lib_out = torch.linalg.vecdot(coeff, vals, dim=0)
    err = max_err(out, lib_out)
    if not err <= 1e-5 * float(lib_out.abs().max()):
        fail(f"combine (m={m}, n={n}): off torch.linalg.vecdot by {err}")
    del lib_out
    ts = [time_ms(torch, f) for f in (
        run, lambda: torch.linalg.vecdot(coeff, vals, dim=0), run)]
    ms, lib = (ts[0] + ts[2]) / 2, ts[1]
    plain = time_ms(torch, lambda: combine_ref(coeff, vals, False), reps=1,
                    warmup=False)
    b = bound(nbytes(coeff, vals, out), 2.0 * coeff.numel())
    say(f"  combine (the readout without a slot; m={m}, n={n}, sum): "
        f"{ms:.4f} ms (turns {ts[0]:.4f}, {ts[2]:.4f}); "
        f"torch.linalg.vecdot {lib:.4f} ms (off by {err:.3g}); plain "
        f"{plain:.4f} ms; bound {b[0]:.4f} ms ({b[0] / ms:.1%} of it)")
    return dict(ms=ms, bound_ms=b[0], plain_ms=plain, library_ms=lib)


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
    Returns the steps, (counts, counts by shape), the two models and the
    queries (phase 10 serves them again, sharded)."""
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
    return active, (counts, shapes), models, xq


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
        life, life_counts, life_models, life_xq = serve_lifecycle(
            torch, dev, f"{tmp}/versions", seed)
    return dict(predictor=pred, counts=(counts, shapes), graphs=graphs,
                warm=warm, lifecycle=life, lifecycle_counts=life_counts,
                life_models=life_models, life_xq=life_xq)


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
                                             readout_ref, route_unpack_ref,
                                             scatter_blocked_ref, scatter_ref)
    from repro_torch.kernels.binning.ref import combine_ref
    from repro_torch.kernels.featurize import featurize_ref
    if name == "featurize":
        err = compare_featurize(torch, got, featurize_ref(**a), what)
        return dict(err=err, share=err / 2e-6, seen=True)
    if name == "route_unpack":
        # B8 multiplies each read once: the plain version's bits
        err = max_err(got, route_unpack_ref(a["cell_lay"], a["coeff_lay"],
                                            a["back"]))
        if err != 0.0:
            fail(f"route_unpack {what}: differs from its plain version by "
                 f"{err}")
        return dict(err=err, share=0.0, seen=True)
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
    elif a["slot"] is None:
        # the readout without a slot: point i reads column i
        plain = lambda f: combine_ref(f(a["coeff"]), f(a["tables"]),
                                      a["average"])
    else:
        plain = lambda f: readout_ref(a["slot"], f(a["coeff"]),
                                      f(a["tables"]), a["average"])
    want = plain(lambda t: t)
    if not want.numel():
        return dict(err=0.0, share=0.0, seen=False)
    diff = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    abs_sum = plain(torch.abs).double()
    terms = (a["coeff"].shape[0] if name == "bin_readout"
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
    for phase 5 to time; for the kernels named in ``keep``, its inputs at
    every shape (``kept``: {name: {shape: arguments}})."""

    def __init__(self, torch, held=HELD, keep=()):
        self.torch = torch
        self.held = held
        self.kept = {name: {} for name in keep}
        # name: {shape: plain_err's result}
        self.errs = {name: {} for name in held}
        self.zeros = {name: set() for name in held}  # all-zero outputs
        # name: (bytes, shape, arguments, output not all zeros)
        self.largest = {}

    def __enter__(self):
        import importlib
        self.saved = []
        for name, (module, attr) in self.held.items():
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
            if name in self.kept and shape not in self.kept[name]:
                self.kept[name][shape] = {
                    k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in a.items()}
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
    pts = a["coeff"].numel()
    if a["slot"] is None:         # the combine: coeff and the values once
        return bound(nbytes(a["coeff"], a["tables"], out), 2.0 * k * pts)
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
        lib = ""
        if name == "bin_scatter_blocked" and a["contrib_lay"].ndim == 2:
            # forest's layout (phase 9 (b)): index_add_ at the same inputs
            lib_ms = index_add_ms(torch, a["slot_lay"], a["contrib_lay"],
                                  run().shape[1])
            extra[name]["tables_library_ms"] = lib_ms
            lib = f"; index_add_ {lib_ms:.4f} ms ({card_line()})"
        say(f"  {name} at phase 9's largest shape {shape}: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it){lib}")
    held.largest.clear()
    return extra


# ---------------------------------------------------------------------------
# phase 10: sharded KRR serving of phase 3's model
# ---------------------------------------------------------------------------

# (a) a 1x1 grid on phase 6's NCCL group; (b) a 2x2 grid of four processes
# sharing the one card over gloo (NCCL refuses two ranks on one device)
SHARD = dict(grid=(2, 2), stream_b=2048, warm_reps=20, timeout_s=300.0)
SHARD_DISK_GIB = 2.2      # one export of phase 3's model at a time, and room
# the kernels of a sharded predict, each held against its plain version at
# every new shape: B1, the readout's combine (B4) and, with dedup, B8
SHARD_HELD = {"featurize": HELD["featurize"],
              "bin_readout": HELD["bin_readout"],
              "route_unpack": ("repro_torch.kernels.binning.ops",
                               "route_unpack_cuda")}


def check_disk(path, gib, what):
    import shutil
    free = shutil.disk_usage(path).free
    if free < gib * 2**30:
        fail(f"{what}: {free / 2**30:.2f} GiB free under {path}, "
             f"{gib} GiB needed")


def served_bitwise(what, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"phase 10: {what} differs from phase 8's Predictor"
             + (f" by {np.abs(got - want).max()}"
                if got.shape == want.shape else f" in shape {got.shape}"))


def served_close(what, got, want):
    """Within 1e-5 of max|want| (the JAX package's 2x2 bound)."""
    err = float(np.abs(got.astype(np.float64) - want).max())
    lim = 1e-5 * float(np.abs(want).max())
    if not err <= lim:
        fail(f"phase 10: {what} differs from phase 8's Predictor by {err} "
             f"> {lim}")
    return err


def repeats_equal(what, stream, res):
    first = {}
    for i, r in enumerate(stream):
        j = first.setdefault(r.tobytes(), i)
        if not np.array_equal(res[i], res[j]):
            fail(f"phase 10: {what}: repeat of request {j} served "
                 f"differently")


def mean_us(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def sharded_1x1(torch, dev, data, model, serving, tmp, seed):
    """(a): phase 3's model as a 1x1 piece grid on phase 6's NCCL group,
    in both routes; then the lifecycle at phase 8's scale."""
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.launch.krr_serve import _synthetic_stream, serve_stream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import (ShardedPredictor, bucket_sizes,
                                   export_artifact_sharded)
    import torch.distributed as dist
    pred8 = serving["predictor"]
    Path(tmp).mkdir(parents=True)
    check_disk(tmp, SHARD_DISK_GIB, "phase 10 (a)")
    art = f"{tmp}/grid1x1"
    t0 = time.perf_counter()
    export_artifact_sharded(art, model, mesh_shape=(1, 1),
                            golden_queries=SERVE["golden"])
    t_export = time.perf_counter() - t0
    mesh = make_host_mesh(device=dev)
    say(f"  (a) 1x1 grid on the {dist.get_backend()} group of "
        f"{dist.get_world_size()} rank: export {t_export:.2f} s, "
        f"{dir_bytes(art)} bytes")
    buckets = bucket_sizes(SERVE["max_batch"])
    rows = data[2][:SERVE["max_batch"]].cpu().numpy()
    stream = _synthetic_stream(MAIN["d"], SERVE["stream"],
                               SERVE["dup_frac"], seed)
    out, counted, errs = {}, {}, {}
    for dedup in (False, True):
        route = "dedup" if dedup else "broadcast"
        reset_launch_counts()
        with HeldToPlain(torch, SHARD_HELD,
                         keep=("route_unpack",) if dedup else ()) as held:
            pred = ShardedPredictor(mesh=mesh, max_batch=SERVE["max_batch"],
                                    cache_entries=SERVE["cache_entries"],
                                    dedup=dedup)
            t0 = sync_clock(torch)
            aid = pred.load(art)
            t_load = sync_clock(torch) - t0
            golden = pred._hosted(aid).manifest["golden"]
            gx = np.asarray(golden["x"], np.float32)
            t0 = time.perf_counter()
            n_b = pred.warmup()
            t_warm = time.perf_counter() - t0
            if n_b != len(buckets):
                fail(f"phase 10 (a) {route}: warmup ran {n_b} buckets, not "
                     f"{len(buckets)}")
            served = {b: pred.predict(rows[:b], use_cache=False)
                      for b in buckets}
            got_golden = pred.predict(gx, use_cache=False)
        stats = serve_stream(pred, stream, max_batch=SERVE["batch"],
                             max_wait_us=SERVE["wait_us"])
        counts, shapes = launch_counts(), launch_counts_by_shape()
        need = ("featurize", "bin_readout") + (
            ("route_unpack",) if dedup else ())
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            fail(f"phase 10 (a) {route}: kernels not launched: {missing}")
        if not dedup and counts["route_unpack"]:
            fail("phase 10 (a) broadcast: B8 launched off its route")
        counted[route] = (counts, shapes)
        errs[route] = held.summary()
        if dedup:
            b8_args = held.kept["route_unpack"]
        out[dedup] = dict(pred=pred, served=served, golden=got_golden,
                          gold=golden, stats=stats,
                          cache=pred.cache_stats(), load_s=t_load,
                          warm_s=t_warm)
        say(f"      {route}: load {t_load:.2f} s, warmup of {n_b} buckets "
            f"{t_warm:.2f} s; launches (counted: warmup, a request at every "
            f"bucket, the golden block, the stream) "
            f"{ {k: v for k, v in counts.items() if v} }; held to plain: "
            f"{errs[route]}")

    # outside the counts: every answer against phase 8's Predictor, bitwise
    for dedup, o in out.items():
        route = "dedup" if dedup else "broadcast"
        for b, got in o["served"].items():
            served_bitwise(f"(a) {route}: a request of {b} rows", got,
                           pred8.predict(rows[:b], use_cache=False))
        served_bitwise(f"(a) {route}: the golden block", o["golden"],
                       pred8.predict(np.asarray(o["gold"]["x"], np.float32),
                                     use_cache=False))
        gerr = float(np.abs(o["golden"] - np.asarray(o["gold"]["y"])).max())
        if not gerr <= o["gold"]["tol"]:
            fail(f"phase 10 (a) {route}: golden block off by {gerr}")
        st = o["stats"]
        if st["served"] != SERVE["stream"]:
            fail(f"phase 10 (a) {route}: stream served {st['served']}")
        served_bitwise(f"(a) {route}: the stream", st["results"],
                       pred8.predict(stream, use_cache=False))
        repeats_equal(f"(a) {route}", stream, st["results"])
        say(f"      {route} stream: {st['served']} single-row requests "
            f"(dup_frac {SERVE['dup_frac']}, max_batch {SERVE['batch']}, "
            f"max_wait_us {SERVE['wait_us']}): p50 {st['p50_us']:.1f} us, "
            f"p99 {st['p99_us']:.1f} us, {st['qps']:.0f} QPS, "
            f"{st['batches']} batches of mean {st['mean_batch']:.2f} rows, "
            f"cache hit rate {o['cache']['hit_rate']:.3f}")
    say("      every answer (a request at each bucket, the golden block, "
        "the stream) bitwise equal to phase 8's Predictor on its rows, in "
        "both routes; repeats equal their first answer")
    pred = out[False]["pred"]
    warm = {}
    for b in buckets:
        x = rows[:b]
        warm[b] = dict(
            sharded_us=mean_us(lambda: pred.predict(x, use_cache=False),
                               SHARD["warm_reps"]),
            graph_us=serving["warm"][b]["warm_us"],
            eager_us=serving["warm"][b]["eager_us"])
    say(f"      by bucket, us (host clock; sharded predict(), mean of "
        f"{SHARD['warm_reps']} / phase 8's graph warm path / phase 8's "
        f"eager wlsh_krr_predict): " + ", ".join(
            f"{b}: {t['sharded_us']:.1f} / {t['graph_us']:.1f} / "
            f"{t['eager_us']:.1f}" for b, t in warm.items()))
    for b in (1, SERVE["max_batch"]):
        # the device's share of a sharded predict: its kernels (the
        # collectives' included) by torch.profiler
        split = device_split(torch, lambda: pred.predict(
            rows[:b], use_cache=False), reps=SHARD["warm_reps"])
        busy = sum(split.values()) * 1e3
        warm[b]["busy_us"] = busy
        top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
        say(f"      bucket {b}: device busy {busy:.1f} us a predict, "
            f"{busy / warm[b]['sharded_us']:.1%} of its wall; by kernel "
            f"(us): " + ", ".join(f"{kernel_name(k)[:48]} {v * 1e3:.1f}"
                                   for k, v in top))
        ops, host = host_split(torch, lambda: pred.predict(
            rows[:b], use_cache=False), reps=SHARD["warm_reps"])
        warm[b]["host_self_us"] = host
        say(f"      bucket {b}: host self time {host:.1f} us a predict "
            f"(torch.profiler, CPU); top operators (us): " + ", ".join(
                f"{k} {v:.1f}" for k, v in ops))
    b8 = b8_bucket_times(torch, b8_args)
    del b8_args
    for o in out.values():
        o["pred"].unload(aid)
        o["pred"].stop()
        del o["pred"]
    life, life_counts = sharded_lifecycle(torch, mesh, serving,
                                          f"{tmp}/versions")
    return dict(counts=counted, lifecycle=life, lifecycle_counts=life_counts,
                warm=warm, errs=errs, b8_buckets=b8,
                stats={("dedup" if k else "broadcast"): dict(
                    p50_us=o["stats"]["p50_us"], p99_us=o["stats"]["p99_us"],
                    qps=o["stats"]["qps"],
                    hit_rate=o["cache"]["hit_rate"])
                    for k, o in out.items()})


def b8_bucket_times(torch, kept):
    """B8 at each shape the dedup route launched it at (``kept``: the
    arguments ``HeldToPlain`` copied there), new design against its first
    in turns: device ms by torch.profiler (events over launches back to
    back time the host at these sizes).  Its bits are its plain
    version's, held as it ran.  A list of {shape, ms, first_design_ms}."""
    from repro_torch.kernels.binning import route_unpack_cuda
    from repro_torch.kernels.binning.variants import route_unpack_v1_cuda
    rows = []
    for shape, a in sorted(kept.items()):
        t = turns(torch, dict(
            new=lambda a=a: route_unpack_cuda(**a),
            first=lambda a=a: route_unpack_v1_cuda(**a)), rounds=1)
        ms = {k: sum(v) / len(v) if v else None for k, v in t.items()}
        rows.append(dict(shape=f"m={shape[0][0]} L={shape[0][1]} "
                         f"cells={shape[2][0]}", ms=ms["new"],
                         first_design_ms=ms["first"]))
    say("      B8 in the dedup route, device ms by torch.profiler, new / "
        "first design, in turns: " + ", ".join(
            f"{r['shape']}: " + " / ".join(
                "not measured" if v is None else f"{v:.4f}"
                for v in (r["ms"], r["first_design_ms"])) for r in rows)
        + f" ({card_line()})")
    return rows


def sharded_lifecycle(torch, mesh, serving, root):
    """ServingRuntime over a root of 1x1 piece grids of phase 8's
    lifecycle models (n = 2^16, B = 2^18): v1 served; v2 with its piece
    scaled on disk (the canary rejects it); v3 with its piece and no
    manifest (invisible); v4 a mixed-generation grid (refused at load); v5
    swapped in, then rollback() to v1, whose answers must be
    wlsh_krr_predict's bits.  Counts reset before, read after."""
    import repro_torch.core as T
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (LifecycleConfig, ServingRuntime,
                                   ShardedPredictor, bucket_sizes,
                                   discover_versions,
                                   export_artifact_sharded, version_dir)
    from repro_torch.testing.faults import (mixed_generation_publish,
                                            poison_piece, torn_publish)
    m0, m1 = serving["life_models"]
    xq = serving["life_xq"]
    shape = (1, 1)
    reset_launch_counts()
    pred = ShardedPredictor(mesh=mesh, max_batch=SERVE["max_batch"])
    rt = ServingRuntime(root, predictor=pred, config=LifecycleConfig(
        probation_s=0.0, retain=2, warm_sizes=bucket_sizes(SERVE["batch"])))
    v = lambda n: version_dir(root, n)
    steps = []

    def step(label, publish):
        publish()
        r = rt.poll_once()
        steps.append((label, r["action"], rt.active_version))

    def poisoned():
        export_artifact_sharded(v(2), m0, mesh_shape=shape)
        poison_piece(v(2), (0, 0), scale=3.0)

    step("v1", lambda: export_artifact_sharded(v(1), m0, mesh_shape=shape))
    step("v2 poisoned piece", poisoned)
    step("v3 pieces, no manifest", lambda: torn_publish(
        v(3), m1, mesh_shape=shape, after_saves=1))
    step("v4 mixed generations", lambda: mixed_generation_publish(
        v(4), m1, mesh_shape=shape, stale=(0, 0)))
    step("v5", lambda: export_artifact_sharded(v(5), m1, mesh_shape=shape))
    ok = rt.rollback("chip_smoke: rollback to v1")
    steps.append(("rollback()", "rollback" if ok else "refused",
                  rt.active_version))
    served = rt.predict(xq, use_cache=False)
    counts = launch_counts()
    pred.stop()
    want = (("v1", "swap", 1), ("v2 poisoned piece", "canary_reject", 1),
            ("v3 pieces, no manifest", "none", 1),
            ("v4 mixed generations", "load_rejected", 1),
            ("v5", "swap", 5), ("rollback()", "rollback", 1))
    if tuple(steps) != want:
        fail(f"phase 10 (a) lifecycle: {steps}")
    if 3 in [n for n, _ in discover_versions(root, sharded=True)]:
        fail("phase 10 (a) lifecycle: v3 without a manifest is visible")
    served_bitwise("(a) lifecycle: v1 after rollback", served,
                   T.wlsh_krr_predict(m0, xq).cpu().numpy())
    missing = [k for k in ("featurize", "bin_readout") if counts[k] <= 0]
    if missing:
        fail(f"phase 10 (a) lifecycle: kernels not launched: {missing}")
    say(f"      lifecycle (phase 8's models, n = 2^16, B = 2^18, 1x1 "
        f"grids): " + "; ".join(f"{a}: {b} (active v{c})"
                                 for a, b, c in steps)
        + f"; v1 after rollback bitwise equal to wlsh_krr_predict; "
        f"rejected {rt.health()['rejected_versions']}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return steps, counts


def _grid_rank(rank, world, device, store, art, rows, stream, out_dir):
    """One rank of (b), in its own process: a gloo group on ``device``
    (four ranks share the card), its piece, the predictor; rank 0 serves
    the requests and the batcher's stream, the others run the worker
    loop.  Every B1, readout and B8 launch is held against its plain
    version at each new shape.  Writes its record to out_dir."""
    sys.path.insert(0, str(REPO / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.krr_serve import serve_stream
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.serve import ShardedPredictor, bucket_sizes
    torch.set_num_threads(1)
    dev = init_distributed(torch.device(device), backend="gloo",
                           init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=SHARD["timeout_s"])
    mesh = make_host_mesh(SHARD["grid"][0], device=dev)
    res = dict(rank=rank, model_rank=mesh.model_rank,
               data_rank=mesh.data_rank, backend=dist.get_backend())
    reset_launch_counts()
    with HeldToPlain(torch, SHARD_HELD) as held:
        pred = ShardedPredictor(mesh=mesh, max_batch=SERVE["max_batch"],
                                cache_entries=SERVE["cache_entries"])
        if pred.is_front:
            try:
                t0 = time.perf_counter()
                aid = pred.load(art)
                res["load_s"] = time.perf_counter() - t0
                gold = pred._hosted(aid).manifest["golden"]
                t0 = time.perf_counter()
                pred.warmup()
                res["warmup_s"] = time.perf_counter() - t0
                buckets = bucket_sizes(SERVE["max_batch"])
                res["served"] = {b: pred.predict(rows[:b], use_cache=False)
                                 for b in buckets}
                res["gold"] = gold
                res["golden"] = pred.predict(
                    np.asarray(gold["x"], np.float32), use_cache=False)
                st = serve_stream(pred, stream, max_batch=SERVE["batch"],
                                  max_wait_us=SERVE["wait_us"])
                res["stream"] = {k: st[k] for k in (
                    "served", "results", "p50_us", "p99_us", "qps",
                    "batches", "mean_batch")}
                res["cache"] = pred.cache_stats()
                res["warm_us"] = {
                    b: mean_us(lambda b=b: pred.predict(rows[:b],
                                                        use_cache=False),
                               SHARD["warm_reps"]) for b in buckets}
            finally:
                pred.stop()
        else:
            pred.serve_forever()
        # every rank holds a piece of its own: 1/4 of the tables
        share = pred._handles[0].share
        res["piece_bytes"] = nbytes(share.table)
    res["counts"] = launch_counts()
    res["held"] = held.summary()
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def sharded_2x2(torch, dev, data, model, serving, tmp, seed):
    """(b): phase 3's model as a 2x2 piece grid, four processes on the one
    card over gloo, each loading only its piece."""
    import torch.multiprocessing as mp
    from repro_torch.launch.krr_serve import _synthetic_stream
    from repro_torch.serve import bucket_sizes, export_artifact_sharded
    pred8 = serving["predictor"]
    check_disk(tmp, SHARD_DISK_GIB, "phase 10 (b)")
    art = f"{tmp}/grid2x2"
    t0 = time.perf_counter()
    export_artifact_sharded(art, model, mesh_shape=SHARD["grid"],
                            golden_queries=SERVE["golden"])
    t_export = time.perf_counter() - t0
    rows = data[2][:SERVE["max_batch"]].cpu().numpy()
    stream = _synthetic_stream(MAIN["d"], SHARD["stream_b"],
                               SERVE["dup_frac"], seed + 2)
    world = SHARD["grid"][0] * SHARD["grid"][1]
    out_dir = Path(tmp) / "ranks"
    out_dir.mkdir()
    t0 = time.perf_counter()
    mp.spawn(_grid_rank, args=(world, str(dev), f"{tmp}/pg_store", art, rows,
                               stream, str(out_dir)),
             nprocs=world, join=True)
    t_spawn = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    r0 = ranks[0]
    err = 0.0
    for b, got in r0["served"].items():
        err = max(err, served_close(f"(b) a request of {b} rows", got,
                                    pred8.predict(rows[:b], use_cache=False)))
    gerr = float(np.abs(r0["golden"] - np.asarray(r0["gold"]["y"])).max())
    if not gerr <= r0["gold"]["tol"]:
        fail(f"phase 10 (b): golden block off by {gerr}")
    st = r0["stream"]
    if st["served"] != SHARD["stream_b"]:
        fail(f"phase 10 (b): stream served {st['served']}")
    err = max(err, served_close("(b) the stream", st["results"],
                                pred8.predict(stream, use_cache=False)))
    repeats_equal("(b)", stream, st["results"])
    for r in ranks:
        missing = [k for k in ("featurize", "bin_readout")
                   if r["counts"][k] <= 0]
        if missing:
            fail(f"phase 10 (b): rank {r['rank']} launched no {missing}")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in KERNELS}
    say(f"  (b) {SHARD['grid'][0]}x{SHARD['grid'][1]} grid: {world} "
        f"processes sharing the one card over {r0['backend']} (host-staged "
        f"collectives: these times are of ranks sharing one card, not of a "
        f"sharded deployment); export {t_export:.2f} s, each rank loads "
        f"its piece ({r0['piece_bytes']} bytes), rank 0's load "
        f"{r0['load_s']:.2f} s, warmup {r0['warmup_s']:.2f} s, spawn to "
        f"exit {t_spawn:.2f} s")
    say(f"      every answer within {err:.3g} of phase 8's Predictor "
        f"(limit 1e-5 of max|pred|), repeats equal their first answer, "
        f"golden within {gerr:.3g}; launches over the ranks "
        f"{ {k: v for k, v in counts.items() if v} }; held to plain, by "
        f"rank: " + " | ".join(f"{r['rank']} (data {r['data_rank']}, model "
                               f"{r['model_rank']}): {r['held']}"
                               for r in ranks))
    say(f"      stream: {st['served']} single-row requests: p50 "
        f"{st['p50_us']:.1f} us, p99 {st['p99_us']:.1f} us, "
        f"{st['qps']:.0f} QPS, {st['batches']} batches of mean "
        f"{st['mean_batch']:.2f} rows, cache hit rate "
        f"{r0['cache']['hit_rate']:.3f}; by bucket, sharded predict() us: "
        + ", ".join(f"{b}: {t:.1f}" for b, t in r0["warm_us"].items()))
    return dict(counts=counts, stream=dict(
        p50_us=st["p50_us"], p99_us=st["p99_us"], qps=st["qps"],
        hit_rate=r0["cache"]["hit_rate"]), warm_us=r0["warm_us"], err=err)


def phase_sharded(torch, data, model, serving, seed):
    """Phase 10: sharded KRR serving of phase 3's model through
    ``repro_torch.serve.ShardedPredictor``: (a) a 1x1 grid on phase 6's
    NCCL group, both routes, and the lifecycle; (b) a 2x2 grid of four
    processes on the one card over gloo."""
    import shutil
    import tempfile
    say("== phase 10: sharded KRR serving of phase 3's model (piece grids, "
        "rank 0 fronts, every rank its piece)")
    t_start = time.perf_counter()
    dev = data[0].device
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        a = sharded_1x1(torch, dev, data, model, serving, f"{tmp}/a", seed)
        shutil.rmtree(f"{tmp}/a")
        torch.cuda.empty_cache()
        b = sharded_2x2(torch, dev, data, model, serving, tmp, seed)
    counts = {k: sum(c.get(k, 0) for c, _ in a["counts"].values())
              + a["lifecycle_counts"].get(k, 0) + b["counts"].get(k, 0)
              for k in KERNELS}
    say(f"  phase 10 {time.perf_counter() - t_start:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return dict(a=a, b=b, counts=counts)


# ---------------------------------------------------------------------------
# phase 11: LM training of gemma3-1b at its full config
# ---------------------------------------------------------------------------

# bf16 compute from float32 master parameters and AdamW state, batch 8 x
# 2048 (phase 7's prompt), steps through RestartableLoop with one checkpoint
# before an injected failure and one at the end (keep 1)
TRAIN = dict(arch="gemma3-1b", batch=8, seq=2048, steps=6, ckpt_every=3,
             fail_at=5, lr=3e-4)
TRAIN_DISK_GIB = 26       # two 12 GB checkpoints while the older is swept
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)


def train_model_flops(cfg, n: int, batch: int, seq: int
                      ) -> tuple[float, float]:
    """Model FLOPs of one train step: 6 N a token (forward and backward of
    every parameter's product, the tied table's logits included) plus the
    attention products, 12 H dh a token, layer and attended key, at each
    layer's mean key count (causal: (S + 1) / 2; a window W: the mean of
    min(t + 1, W)); ``n`` parameters.  Returns (total, attention part)."""
    tokens = batch * seq
    att = 0.0
    for slot in cfg.layer_pattern * cfg.n_groups:
        w = slot.window or seq
        keys = sum(min(t + 1, w) for t in range(seq)) / seq
        att += 12.0 * cfg.n_heads * cfg.head_dim * keys
    return tokens * (6.0 * n + att), tokens * att


def _grads_of(torch, cfg, params, batch, dtype):
    """(loss, gradient tree) of the port's loss_fn by autograd."""
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_map
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = TM.loss_fn(cfg, leaves, batch, dtype=dtype)
    total.backward()
    return float(metrics["loss"]), tree_map(lambda p: p.grad, leaves)


def _leaf_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def check_logits_f32(torch, dev, seed):
    """The bf16 logits product with float32 accumulation and result
    (``_LogitsF32``: torch.mm's out_dtype, with a backward written for it)
    against the float32 product of the same bf16 values (TF32 off), by
    ``repro_torch.testing.train``: the logits within 1e-5 of max|logit|
    (summation order), the gradients of h and of the float32 table within
    one bf16 rounding of their max (2^-8: the JAX package's transpose
    rounds only its results; its reading on the CPU is in
    tests/test_torch_train.py).  Then one cross-entropy chunk's product
    and its backward timed at phase 11's shape."""
    from repro_torch.models.model import _logits_f32
    from repro_torch.testing.train import ROUNDING, logits_grad_errors
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype, errs = logits_grad_errors(
        torch.randn(2, 512, 1152, generator=g, device=dev),
        0.02 * torch.randn(8192, 1152, generator=g, device=dev),
        torch.randn(2, 512, 8192, generator=g, device=dev))
    # one cross-entropy chunk's product at phase 11's shape: bf16 with a
    # float32 result, its backward (four such products: the head and the
    # tail of the gradient, for h and for the table), bf16, and float32
    # (TF32 off)
    hc = torch.randn(TRAIN["batch"] * 512, 1152, generator=g, device=dev,
                     dtype=torch.bfloat16)
    tc = torch.randn(262144, 1152, generator=g, device=dev,
                     dtype=torch.bfloat16)
    ms = [time_ms(torch, lambda: torch.mm(hc, tc.T, out_dtype=torch.float32))]
    hg, tg = hc.requires_grad_(True), tc.requires_grad_(True)
    out = _logits_f32(hg[None], tg)
    gout = torch.randn_like(out)
    ms.append(time_ms(torch, lambda: torch.autograd.grad(
        out, (hg, tg), gout, retain_graph=True), reps=3))
    del out, gout, hg, tg
    hc, tc = hc.detach(), tc.detach()
    ms.append(time_ms(torch, lambda: hc @ tc.T))
    hc, tc = hc.float(), tc.float()
    ms.append(time_ms(torch, lambda: hc @ tc.T, reps=2))
    del hc, tc
    torch.cuda.empty_cache()
    say(f"  bf16 logits with float32 accumulation (torch.mm out_dtype, "
        f"{card_line()}): logits {errs[0]:.3g} of max (limit 1e-5), "
        f"grad h {errs[1]:.3g}, grad table {errs[2]:.3g} (limit 2^-8 = "
        f"{ROUNDING:.3g}, one bf16 rounding); one chunk's product "
        f"({TRAIN['batch'] * 512} x 1152 x 262144) {ms[0]:.3f} ms, its "
        f"backward {ms[1]:.3f} ms, in bf16 out {ms[2]:.3f} ms, in float32 "
        f"{ms[3]:.3f} ms")
    if dtype != torch.float32 or not (
            errs[0] <= 1e-5 and max(errs[1:]) <= ROUNDING):
        fail(f"phase 11: the float32-accumulated bf16 logits disagree: "
             f"{errs}")


def check_train_smoke(torch, dev, seed):
    """gemma3-1b's smoke config, f32: the card's loss_fn gradients and one
    train step against the port's own on the CPU, to the CPU tests' limits
    (tests/test_torch_train.py): the loss within 1e-5 relative; each
    gradient leaf within max(1e-4, 4x its float32 floor) of its max (the
    floor: how far half an ulp on every parameter moves it, on the CPU and
    on the card, the larger: the smoke config's stacked weights are drawn
    at std 1, so its attention scores are near one-hot, and the card's
    floor is several times the CPU's);
    lr of the step equal, loss within 1e-5 relative, grad_norm within
    what the gradient limits allow (the L2 norm of each leaf's limit over
    its entries); the new parameters within lr * 1e-3 where the clipped
    gradient is above 1e-5 and |g| above its leaf's limit (its sign is
    not noise there: the first step moves by lr g / (|g| + eps)), AdamW's
    bound lr (1 + wd |p|) on both updates elsewhere."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = registry.smoke_config(TRAIN["arch"])
    cpu = TM.init(cfg, torch.Generator().manual_seed(seed))
    card = tree_map(lambda p: p.to(dev), cpu)
    batch = synthetic_lm_batch(seed, 0, batch=4, seq=64,
                               vocab=cfg.vocab_size, device="cpu")
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    l_cpu, g_cpu = _grads_of(torch, cfg, cpu, batch, torch.float32)
    l_card, g_card = _grads_of(torch, cfg, card, dbatch, torch.float32)
    gen = torch.Generator().manual_seed(99)
    moved = tree_map(lambda p: p * (1 + 2.0 ** -24 * (2 * torch.randint(
        0, 2, p.shape, generator=gen) - 1)), cpu)
    _, m_cpu = _grads_of(torch, cfg, moved, batch, torch.float32)
    _, m_card = _grads_of(torch, cfg, tree_map(lambda p: p.to(dev), moved),
                          dbatch, torch.float32)
    worst, noise, norm_tol, floors = 0.0, {}, 0.0, [0.0, 0.0]
    for (path, a), (_, b), (_, c), (_, d) in zip(
            tree_leaves(g_cpu), tree_leaves(g_card), tree_leaves(m_cpu),
            tree_leaves(m_card)):
        floors = [max(floors[0], _leaf_rel(a, c)),
                  max(floors[1], _leaf_rel(b, d))]
        tol = max(1e-4, 4 * max(_leaf_rel(a, c), _leaf_rel(b, d)))
        worst = max(worst, _leaf_rel(a, b) / tol)
        noise[path] = tol * float(a.abs().max())
        norm_tol += a.numel() * noise[path] ** 2
        if _leaf_rel(a, b) > tol:
            fail(f"phase 11: smoke gradient {path} on the card "
                 f"{_leaf_rel(a, b):.3g} off the CPU's (limit {tol:.3g})")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = TS.make_train_step(cfg, opt, dtype=torch.float32)
    p1, _, m1 = step(cpu, adamw_init(cpu), batch)
    p2, _, m2 = step(card, adamw_init(card), dbatch)
    lr = float(m1["lr"])
    for name, lim in (("loss", 1e-5 * abs(float(m1["loss"]))),
                      ("grad_norm", norm_tol ** 0.5), ("lr", 0.0)):
        a, b = float(m1[name]), float(m2[name])
        if not abs(a - b) <= lim:
            fail(f"phase 11: smoke step {name} {b} on the card, {a} on "
                 f"the CPU (limit {lim:.3g})")
    scale = min(1.0, opt.clip_norm / max(float(m1["grad_norm"]), 1e-9))
    far = 0.0
    for (path, a), (_, b), (_, g), (_, p0) in zip(
            tree_leaves(p1), tree_leaves(p2), tree_leaves(g_cpu),
            tree_leaves(cpu)):
        b = b.cpu()
        big = (g.abs() * scale > 1e-5) & (g.abs() > noise[path])
        # AdamW's first-step bound, plus the float32 rounding of p
        cap = lr * (1 + opt.weight_decay * p0.abs()) * (1 + 1e-5) + \
            2.0 ** -23 * p0.abs()
        if big.any():
            far = max(far, float((a - b).abs()[big].max()) / lr)
        if far > 1e-3 or bool(((a - p0).abs() > cap)[~big].any()) or bool(
                ((b - p0).abs() > cap)[~big].any()):
            fail(f"phase 11: smoke step parameter {path} off the CPU's")
    say(f"  smoke config, f32, card against CPU ({card_line()}): loss "
        f"{l_card:.6f} / {l_cpu:.6f}; gradients at {worst:.3g} of their "
        f"limits (float32 floor up to {floors[0]:.3g} of a leaf's max on "
        f"the CPU, {floors[1]:.3g} on the card); grad norm {float(m2['grad_norm']):.6f} / "
        f"{float(m1['grad_norm']):.6f}; one step's parameters within "
        f"{far:.3g} lr where the gradient's sign is not noise (limit 1e-3)")
    if not abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu):
        fail(f"phase 11: smoke loss {l_card} on the card, {l_cpu} on the "
             f"CPU")


def phase_train(torch, dev, seed):
    """Phase 11: gemma3-1b at its full config trained through the port's
    train step in RestartableLoop (launch/train.py's build), with an
    injected failure after one checkpoint; then the 2-microbatch step
    against the full one.  Returns the counted run's launches."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps as TS
    from repro_torch.launch.train import build
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureInjector, RestartableLoop
    b, s, n_steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    cfg, step_fn = build(TRAIN["arch"], smoke=False, steps=n_steps,
                         lr=TRAIN["lr"], dtype=torch.bfloat16)
    n = TM.count_params(cfg)
    say(f"== phase 11: LM training, {cfg.name} at its full config ({n:,} "
        f"parameters; bf16 compute, float32 master parameters and AdamW "
        f"state), batch {b} x {s}, {n_steps} steps, a checkpoint every "
        f"{TRAIN['ckpt_every']}, a failure injected at step "
        f"{TRAIN['fail_at']} ({card_line()})")
    check_logits_f32(torch, dev, seed)
    check_train_smoke(torch, dev, seed)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    say(f"  device memory held by the earlier phases: {held / 2**30:.2f} GiB")

    history = []       # (step, loss, grad_norm, lr) of every run step
    marks = []         # CUDA events around each step's step_fn

    def loop_step(state, step):
        batch = synthetic_lm_batch(seed, step, batch=b, seq=s,
                                   vocab=cfg.vocab_size, device=dev)
        e, f = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e.record()
        p, o, m = step_fn(state["params"], state["opt"], batch)
        f.record()
        marks.append((e, f))
        return {"params": p, "opt": o}, m

    def on_metrics(step, m):
        history.append((step - 1, float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        check_disk(tmp, TRAIN_DISK_GIB, "phase 11's checkpoints")
        t0 = sync_clock(torch)
        state0 = dict(zip(("params", "opt"), TS.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(seed))))
        say(f"  parameters and AdamW state made in "
            f"{sync_clock(torch) - t0:.2f} s")
        loop = RestartableLoop(loop_step, tmp,
                               checkpoint_every=TRAIN["ckpt_every"], keep=1,
                               injector=FailureInjector((TRAIN["fail_at"],)))
        hist = lambda name: obs.histogram(name).state()[1:]
        save0, restore0 = hist("io_checkpoint_save_us"), hist(
            "io_checkpoint_restore_us")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = loop.run(state0, n_steps, on_metrics=on_metrics)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        save1, restore1 = hist("io_checkpoint_save_us"), hist(
            "io_checkpoint_restore_us")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state0

    say(f"  launches of the port's kernels in the run: "
        f"{ {k: v for k, v in counts.items() if v} or 'none'} (training "
        f"attends over the full sequence: no B9)")
    if loop.restarts != 1 or result.step != n_steps:
        fail(f"phase 11: {loop.restarts} restarts, ended at step "
             f"{result.step} of {n_steps}")
    say("  step: loss, grad norm, lr (" + card_line() + "): " + "; ".join(
        f"{st} {lo:.4f} {gn:.4f} {lr:.2e}" for st, lo, gn, lr in history))
    if not all(np.isfinite(v) for h in history for v in h[1:3]):
        fail("phase 11: a non-finite loss or grad norm")
    first = {}
    for st, lo, gn, _ in history:
        if st in first:
            rel = abs(lo - first[st]) / abs(first[st])
            say(f"  replayed step {st}: loss {lo:.6f} against "
                f"{first[st]:.6f} before the failure ({rel:.3g} relative, "
                f"limit 1e-3)")
            if not rel <= 1e-3:
                fail(f"phase 11: replayed step {st} loss {lo} != {first[st]}")
        else:
            first[st] = lo
    replayed = len(history) - len(first)
    if replayed != TRAIN["fail_at"] - TRAIN["ckpt_every"]:
        fail(f"phase 11: {replayed} steps replayed")

    # device time of the steps after the first, from the events around
    # step_fn; its optimizer share is the profiled step's (below)
    walls = loop.watchdog.times[1:]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    step_s = med(walls)
    dev_ms = med([e.elapsed_time(f) for e, f in marks[1:]])
    flops, att = train_model_flops(cfg, n, b, s)
    mfu = flops / (dev_ms * 1e-3) / PEAK_BF16_OPS_PER_S
    state_gib = 12 * n / 2**30
    say(f"  step (median of {len(walls)} after the first; {card_line()}): "
        f"wall {step_s * 1e3:.1f} ms (batch made on the host included), "
        f"device {dev_ms:.1f} ms (CUDA events around the step); "
        f"{b * s / step_s:.0f} tokens/s by the wall, "
        f"{b * s / dev_ms * 1e3:.0f} by the device; first step "
        f"{loop.watchdog.times[0] * 1e3:.1f} ms")
    say(f"  model FLOPs a step {flops / 1e12:.2f} T (6 N = "
        f"{6 * n * b * s / 1e12:.2f} T over {b * s} tokens, attention "
        f"{att / 1e12:.2f} T at the causal and 512-windowed key counts): "
        f"MFU {mfu:.1%} of the dense bf16 peak 989 TFLOP/s over the "
        f"device time")
    say(f"  peak device memory {peak / 2**30:.2f} GiB, "
        f"{(peak - held) / 2**30:.2f} of it phase 11's; reckoned: "
        f"parameters, m and v {state_gib:.2f} GiB, twice (the loop keeps "
        f"the initial state to restart from before a checkpoint), "
        f"gradients {4 * n / 2**30:.2f}, the bf16 compute copy "
        f"{2 * n / 2**30:.2f}, one cross-entropy chunk's float32 logits "
        f"{b * 512 * cfg.vocab_size * 4 / 2**30:.2f} GiB each")
    dsave = (save1[0] - save0[0]) / max(save1[1] - save0[1], 1) / 1e6
    drest = (restore1[0] - restore0[0]) / max(
        restore1[1] - restore0[1], 1) / 1e6
    say(f"  checkpoints of {state_gib * 2**30 / 1e9:.1f} GB: each file "
        f"write {dsave:.2f} s (worker thread, io_checkpoint_save_us), the "
        f"npz read of the restore {drest:.2f} s "
        f"(io_checkpoint_restore_us); the loop {wall:.1f} s, "
        f"{wall - sum(loop.watchdog.times):.1f} s of it outside the steps "
        f"(the copies to the host, the restore to the card, the last "
        f"write's wait)")

    # 2 microbatches against the full batch.  (a) From the run's state:
    # read in bf16 and float32, not gated.  Its stacked weights were drawn
    # at std 1/sqrt(groups) = 1 (gemma3's 26 slots are one group), so
    # attention is near one-hot and the gradient is carried by near-ties
    # of the scores; the products of 8192 rows round otherwise than those
    # of 16384, and that moves the grad norm by percents even in float32.
    # (b) From weights drawn at std 1/sqrt(fan-in), where attention is not
    # near one-hot: loss and grad norm within 1e-3 relative in both.
    st = result.state
    del result
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], total_steps=n_steps,
                          warmup_steps=max(10, n_steps // 20))
    batch = synthetic_lm_batch(seed, n_steps, batch=b, seq=s,
                               vocab=cfg.vocab_size, device=dev)
    readings = {"from the run's state": microbatch_readings(
        torch, cfg, opt_cfg, st, batch)}
    profile_train_step(torch, TS.make_train_step(
        cfg, opt_cfg, dtype=torch.bfloat16), st, batch)
    del st
    torch.cuda.empty_cache()
    readings["from a fan-in draw"] = microbatch_readings(
        torch, cfg, opt_cfg, fan_in_state(torch, cfg, dev, seed), batch)
    del batch
    torch.cuda.empty_cache()
    rel = lambda x, y: abs(x - y) / abs(y)
    for where, r in readings.items():
        for dt, ((l1, g1, t1), (l2, g2, t2)) in r.items():
            gated = where == "from a fan-in draw"
            say(f"  2 microbatches against the full batch {where}, {dt} "
                f"({card_line()}): loss {l2:.6f} / {l1:.6f} "
                f"({rel(l2, l1):.3g} relative), grad norm {g2:.6f} / "
                f"{g1:.6f} ({rel(g2, g1):.3g} relative)"
                f"{' (limits 1e-3)' if gated else ' (not gated)'}; "
                f"{t2 * 1e3:.1f} / {t1 * 1e3:.1f} ms")
            if not np.isfinite([l1, l2, g1, g2]).all() or gated and not (
                    rel(l2, l1) <= 1e-3 and rel(g2, g1) <= 1e-3):
                fail(f"phase 11: microbatched step {where} in {dt}: {l2}, "
                     f"{g2} against {l1}, {g1}")
    return counts


def microbatch_readings(torch, cfg, opt_cfg, state, batch):
    """The train step from ``state`` on ``batch`` whole and in 2
    microbatches, in bf16 and float32 compute (TF32 off): {dtype: [(loss,
    grad norm, seconds) whole, the same in 2]}."""
    from repro_torch.launch import steps as TS
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        got = []
        for nm in (1, 2):
            t0 = sync_clock(torch)
            _, _, m = TS.make_train_step(cfg, opt_cfg, dtype=dtype,
                                         num_microbatches=nm)(
                state["params"], state["opt"], batch)
            got.append((float(m["loss"]), float(m["grad_norm"]),
                        sync_clock(torch) - t0))
            del m
            torch.cuda.empty_cache()
        out[str(dtype).removeprefix("torch.")] = got
    return out


def fan_in_state(torch, cfg, dev, seed):
    """A train state whose stacked weights have std 1/sqrt(their fan-in)
    instead of the init's 1/sqrt(groups) (``repro_torch.testing.train.
    fan_in_scale``, as tests/test_torch_train.py draws its bf16 inputs),
    and a fresh AdamW state."""
    from repro_torch.launch.steps import init_train_state
    from repro_torch.testing.train import fan_in_scale
    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed + 1))
    return {"params": fan_in_scale(cfg, params), "opt": opt}


# kernel names by the work they do in a train step's profile
TRAIN_KERNEL_KINDS = (("matmul", ("gemm", "xmma", "nvjet", "cutlass",
                                  "sm90_", "cublas")),
                      ("softmax", ("softmax",)),
                      ("reduction", ("reduce", "norm")),
                      ("copy", ("copy", "memcpy", "memset", "cat", "fill")))


def profile_train_step(torch, step, state, batch):
    """One train step under torch.profiler: the device's busy time (the
    sum of kernel times: one stream) against the wall, the optimizer's
    share (the kernels under the step's ``OPTIMIZER_RANGE``), by kind of
    kernel (names matched against TRAIN_KERNEL_KINDS, the rest
    elementwise) and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import OPTIMIZER_RANGE
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = sync_clock(torch)
        out = step(state["params"], state["opt"], batch)
        wall = (sync_clock(torch) - t0) * 1e3
    del out
    by_name, opt_ms = {}, 0.0
    for e in prof.events():
        if e.name == OPTIMIZER_RANGE:       # the range, not a kernel
            if e.device_type == DeviceType.CPU:
                opt_ms += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        say("  profiled train step: no device events recorded; the split "
            "is not measured")
        return
    busy = sum(us for _, us in by_name.values()) / 1e3
    kinds = {}
    for name, (n, us) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in TRAIN_KERNEL_KINDS
                     if any(key in low for key in keys)), "elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + us / 1e3
    split = (f"forward + backward {busy - opt_ms:.1f} ms, optimizer "
             f"{opt_ms:.1f} ms" if opt_ms > 0 else
             "the optimizer's share not measured (no device time under "
             "its range)")
    say(f"  profiled train step (torch.profiler; {card_line()}): wall "
        f"{wall:.1f} ms, {sum(n for n, _ in by_name.values())} kernels, "
        f"device busy {busy:.1f} ms ({busy / wall:.1%}): {split}; by kind: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
            kinds.items(), key=lambda kv: -kv[1])))
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        say(f"    {us / 1e3:.1f} ms in {n} x {name[:100]}")


def slots_config(spec):
    """The registry config of a phase 12 arch or a phase 13, 14 or 15 grid,
    cut to ``layers`` (a pattern written out layer by layer, gemma3-1b's, to
    its first ``layers`` entries) and the encoder to ``encoder_layers``."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get_config(spec["arch"])
    if spec.get("layers"):
        pattern = cfg.layer_pattern
        if len(pattern) == cfg.n_layers:
            pattern = pattern[:spec["layers"]]
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"],
                                  layer_pattern=pattern)
    if spec.get("encoder_layers"):
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=spec["encoder_layers"]))
    return cfg


def cache_bytes(cfg, batch: int, seq_len: int) -> int:
    """Bytes of the f32 decode state ``init_cache`` makes for this batch."""
    import math
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_leaves
    return sum(4 * math.prod(s.shape) for _, s in tree_leaves(
        TM.cache_specs(cfg, batch, seq_len)))


def b9_per_step(cfg) -> int:
    return cfg.n_groups * sum((s.kind == "attn") + s.shared_attn +
                              s.cross_attn for s in cfg.layer_pattern)


def moe_drop_counter():
    """A wrapper of ``models.moe._dispatch_row`` that tallies, on the
    device, the (token, expert) pairs of prefill calls kept within
    capacity and all of them; (wrapper, tally list, original)."""
    from repro_torch.models import moe
    real = moe._dispatch_row
    tally = []

    def counting(logits, e, k, cap):
        out = real(logits, e, k, cap)
        b, s, _ = logits.shape
        if s > 1:
            tally.append(((out[0] < s).sum(), b * s * k))
        return out
    return counting, tally, real


def slots_consistency(torch, cfg, spec, params, gen, dev):
    """The prefill/decode consistency check of one phase 12 arch, at
    ``spec['check']``: decode ``steps`` tokens from prefill(x[:S]) against
    prefill(x[:S + steps]); with more than one step (zamba2) also every
    cache leaf (the conv and ssm states, the shared attention's rows)
    against that prefill's caches, each over all groups.  Returns {what:
    max|error| / max|reference|}."""
    import dataclasses
    from repro_torch.launch.steps import source_inputs
    from repro_torch.models import model as TM
    b, s, steps = spec["check"]
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    x = torch.randint(0, cfg.vocab_size, (b, s + steps), generator=gen,
                      device=dev)
    src = source_inputs(cfg, b, gen)
    with torch.inference_mode():
        ref, ref_cache, _ = TM.prefill(cfg, params, {"tokens": x, **src},
                                       dtype=torch.float32)
        # the reference caches wait on the host (zamba2's are 13 GB), and
        # come back one group at a time to be compared
        ref_cache = ({slot: {name: t.cpu() for name, t in leaves.items()}
                      for slot, leaves in ref_cache.items()}
                     if steps > 1 else None)
        torch.cuda.empty_cache()
        _, cache, pos = TM.prefill(cfg, params, {"tokens": x[:, :s], **src},
                                   max_cache_len=s + steps,
                                   dtype=torch.float32)
        for t in range(s, s + steps):
            got, cache = TM.decode_step(cfg, params, cache, x[:, t:t + 1],
                                        pos, dtype=torch.float32)
            pos = pos + 1
    if not (bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(ref).all())):
        fail(f"phase 12 {cfg.name}: non-finite logits")
    errs = {"logits": max_err(got, ref) / float(ref.abs().max())}
    for slot, leaves in (ref_cache or {}).items():
        for name, want in leaves.items():
            diff = top = 0.0
            for g in range(want.shape[0]):
                w = want[g].to(dev)
                diff = max(diff, float((cache[slot][name][g] - w).abs().max()))
                top = max(top, float(w.abs().max()))
            errs[name] = max(errs.get(name, 0.0), diff / top)
    del cache, ref_cache
    torch.cuda.empty_cache()
    return errs


def phase_lm_slots(torch, dev, seed):
    """Phase 12: zamba2-7b, rwkv6-1.6b, mixtral-8x22b (2 layers) and
    whisper-large-v3 at full width served through
    repro_torch.launch.serve.generate, each with its B9 launches counted,
    then its prefill/decode consistency at weights rescaled in place to
    std 1/sqrt(fan-in).  Returns the launches (total, by shape) summed over
    the four counted runs."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.launch import specs
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import source_inputs
    from repro_torch.models import model as TM
    from repro_torch.models import moe
    from repro_torch.models.params import tree_leaves
    from repro_torch.testing.train import fan_in_factors
    say(f"== phase 12: LM serving of the other slot kinds at full width "
        f"(f32, seeded random weights) ({card_line()})")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    say(f"  device memory held by the earlier phases: {held / 2**30:.2f} GiB")
    total, by_shape = {}, {}
    for spec in LM_SLOTS:
        cfg = slots_config(spec)
        b, s, n_gen = spec["batch"], spec["prompt"], spec["gen"]
        steps = n_gen - 1
        if b9_per_step(cfg) != spec["b9"]:
            fail(f"phase 12 {cfg.name}: {b9_per_step(cfg)} B9 layers a "
                 f"step, not {spec['b9']}")
        gen = torch.Generator(device=dev).manual_seed(seed)
        t0 = sync_clock(torch)
        params = TM.init(cfg, gen, torch.float32)
        n = TM.count_params(cfg)
        say(f"  {cfg.name}: {n:,} parameters ({cfg.n_layers} layers"
            + (f" of {slots_config(dict(spec, layers=None)).n_layers}"
               if spec["layers"] else "")
            + f", d_model {cfg.d_model}) made in "
            f"{sync_clock(torch) - t0:.2f} s; batch {b}, prompt {s}, "
            f"{n_gen} greedy tokens")
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev)
        src = source_inputs(cfg, b, gen)
        counting, drops, real = moe_drop_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        moe._dispatch_row = counting
        try:
            ids, t_pre, t_dec = generate(cfg, params, tokens, n_gen,
                                         generator=gen, source=src)
        finally:
            moe._dispatch_row = real
        counts, shapes = launch_counts(), launch_counts_by_shape()
        peak = torch.cuda.max_memory_allocated()
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
        for name, per in shapes.items():
            into = by_shape.setdefault(name, {})
            for key, k in per.items():
                into[key] = into.get(key, 0) + k
        if counts["flash_decode"] != spec["b9"] * steps:
            fail(f"phase 12 {cfg.name}: flash_decode launched "
                 f"{counts['flash_decode']} times, not {spec['b9']} per "
                 f"decode step x {steps}")
        if ids.shape != (b, n_gen) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            fail(f"phase 12 {cfg.name}: generated ids of shape "
                 f"{tuple(ids.shape)} out of range")
        flops = specs.useful_flops(cfg, ShapeSpec("prefill", s, b,
                                                  "prefill"))
        w_bytes = 4 * n
        c_bytes = cache_bytes(cfg, b, s + n_gen)
        say(f"    prefill {b}x{s}: {t_pre * 1e3:.2f} ms, "
            f"{b * s / t_pre:.1f} tokens/s, {flops / 1e12:.2f} model TFLOP "
            f"= {flops / t_pre / PEAK_F32_OPS_PER_S:.1%} of the f32 peak "
            f"67 TFLOP/s; decode {steps} steps: {t_dec / steps * 1e3:.3f} ms "
            f"per step, {b * steps / t_dec:.1f} tok/s; B9 "
            f"{counts['flash_decode'] / steps:g} launches a step, by (B, T, "
            f"KV, G, D, cache dtype) {shapes['flash_decode']}")
        say(f"    peak device memory {peak / 2**30:.2f} GiB against its "
            f"reckoning: earlier phases {held / 2**30:.2f} + weights "
            f"{w_bytes / 2**30:.2f} + decode caches {c_bytes / 2**30:.2f} = "
            f"{(held + w_bytes + c_bytes) / 2**30:.2f} GiB, the rest "
            f"{(peak - held - w_bytes - c_bytes) / 2**30:.2f} GiB the "
            f"prefill's transients")
        if drops:
            kept = sum(int(k) for k, _ in drops)
            pairs = sum(p for _, p in drops)
            say(f"    MoE at capacity factor {cfg.moe.capacity_factor}: "
                f"{pairs - kept} of {pairs} (token, expert) pairs of the "
                f"prefill dropped ({(pairs - kept) / pairs:.3%})")
        say(f"    sample ids {ids[0, :8].tolist()} ...")

        # consistency, at weights rescaled in place to std 1/sqrt(fan-in)
        with torch.no_grad():
            for (_, p), (_, f) in zip(tree_leaves(params),
                                      tree_leaves(fan_in_factors(cfg))):
                if f != 1.0:
                    p.mul_(f)
        t0 = sync_clock(torch)
        errs = slots_consistency(torch, cfg, spec, params, gen, dev)
        cb, cs, cn = spec["check"]
        what = (f"prefill(x[:{cs}]) + {cn} decode steps vs "
                f"prefill(x[:{cs + cn}])" + (" (capacity factor 8.0)"
                                             if cfg.moe else ""))
        say(f"    {what}, batch {cb}, weights at std 1/sqrt(fan-in): "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" of max|reference| (limit 2e-3) in "
            f"{sync_clock(torch) - t0:.1f} s")
        bad = {k: v for k, v in errs.items() if not v <= 2e-3}
        if bad:
            fail(f"phase 12 {cfg.name}: prefill/decode consistency {bad} "
                 f"> 2e-3")
        del params, tokens, src, ids
        torch.cuda.empty_cache()
    return total, by_shape


# ---------------------------------------------------------------------------
# phase 13: the dense LMs served on (data, model) grids of ranks
# ---------------------------------------------------------------------------

# (a) phase 7's run on a 1x1 grid over NCCL through generate(mesh=); (b)
# qwen3-14b at full width cut to 8 of its 40 layers on a 1x4 grid and (c)
# gemma3-1b uncut on a 2x2 grid, each four processes sharing the card over
# gloo, fed the reference's greedy tokens.  ``b9``: the local (KV, G, D) B9
# must run at; ``limit``: the logits' limit of max|logit| against the
# one-process port on the same weights.  gemma3-1b's checkpoint serves (a)
# and (c); each is written once, into a temporary directory.
MESH = dict(
    a=dict(arch="gemma3-1b", layers=None, grid=(1, 1), batch=8, prompt=2048,
           steps=63, b9=(1, 4, 256), limit=1e-5),
    c=dict(arch="gemma3-1b", layers=None, grid=(2, 2), batch=8, prompt=512,
           steps=2, b9=(1, 2, 256), limit=2e-3),
    b=dict(arch="qwen3-14b", layers=2, grid=(1, 4), batch=4, prompt=512,
           steps=4, b9=(2, 5, 128), limit=2e-3))
MESH_DISK_GIB = 10        # qwen3-14b's 2 layers and its tables in f32
                          # (8.9 GB), and room
MESH_TIMEOUT_S = 600.0


def fan_in_init(torch, cfg, dev, seed):
    """Random f32 weights from the seed on ``dev``, each stacked normal
    weight rescaled in place to std 1/sqrt(fan-in)."""
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_leaves
    from repro_torch.testing.train import fan_in_factors
    params = TM.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                     torch.float32)
    with torch.no_grad():
        for (_, p), (_, f) in zip(tree_leaves(params),
                                  tree_leaves(fan_in_factors(cfg))):
            if f != 1.0:
                p.mul_(f)
    return params


def mesh_reference(torch, cfg, params, tokens, steps, source=None,
                   fed=None):
    """The one-process port's prefill of ``tokens`` (with the
    cross-attention ``source``, whisper's frames, where given) and
    ``steps`` greedy decode steps, f32: (ids (B, steps + 1), [logits of
    the prefill and each step]) on the host.  With ``fed`` (ids of another
    run) step t is fed ``fed[:, t]`` instead of its own greedy token."""
    from repro_torch.models import model as TM
    logits = []
    with torch.inference_mode():
        lg, cache, pos = TM.prefill(cfg, params,
                                    {"tokens": tokens, **(source or {})},
                                    max_cache_len=tokens.shape[1] + steps,
                                    dtype=torch.float32)
        ids = [torch.argmax(lg, -1)]
        logits.append(lg.cpu())
        for t in range(steps):
            step = ids[-1] if fed is None else fed[:, t].to(tokens.device)
            lg, cache = TM.decode_step(cfg, params, cache, step[:, None],
                                       pos, dtype=torch.float32)
            pos = pos + 1
            ids.append(torch.argmax(lg, -1))
            logits.append(lg.cpu())
    del cache
    return torch.stack(ids, 1).cpu(), logits


def restore_grid(cfg, ckpt, mesh):
    """This rank's blocks of the checkpoint's parameters, by
    ``param_shardings`` (``restore_resharded``, leaf by leaf)."""
    from repro_torch.checkpoint import restore_resharded
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models import model as TM
    from repro_torch.models.params import tree_leaves
    placement = dict(tree_leaves(param_shardings(cfg, mesh)))
    params, _, _ = restore_resharded(ckpt, TM.abstract_params(cfg),
                                     placement, mesh)
    return params


def write_checkpoint(params, path) -> str:
    """``params`` saved once (step 0, the JAX package's format) for the
    grids to restore; returns the directory."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models.params import tree_leaves
    t0 = time.perf_counter()
    save_checkpoint(path, 0, params)
    nb = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    say(f"  checkpoint of {nb / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.2f} s")
    return path


def _mesh_rank(rank, world, device, store, spec, ckpt, tokens, ref_ids,
               out_dir, source=None):
    """One rank of a spawned grid (phase 13's (b) and (c), phase 14's), in
    its own process: a gloo group on ``device`` (four ranks share the
    card), its blocks restored from the checkpoint; the prefill of the
    global prompt (and the global ``source``, whisper's frames, where
    given), then the decode steps fed the reference's tokens, each step's
    logits gathered over the vocab; the MoE pairs of the prefill kept
    within capacity and all of them.  Writes its record to out_dir."""
    sys.path.insert(0, str(REPO / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.specs import shard_bytes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import moe, sharded
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding import (collective_counts, local_block,
                                      reset_collective_counts)
    from repro_torch.testing.multirank import kv_heads_read
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(torch.device(device), backend="gloo",
                           init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=MESH_TIMEOUT_S)
    mesh = make_host_mesh(spec["grid"][1], device=dev)
    cfg = slots_config(spec)
    t0 = time.perf_counter()
    params = restore_grid(cfg, ckpt, mesh)
    res = dict(rank=rank, data_rank=mesh.data_rank,
               model_rank=mesh.model_rank, backend=dist.get_backend(),
               restore_s=time.perf_counter() - t0)
    b, s = tokens.shape
    n = spec["steps"]
    res["param_bytes"] = sum(t.numel() * t.element_size()
                             for _, t in tree_leaves(params))
    res["shard_bytes"] = shard_bytes(cfg, ShapeSpec("decode", s + n, b,
                                                    "decode"), mesh)
    lay = sharded.GridLayout(cfg, mesh)
    tokens = tokens.to(dev)
    source = {k: v.to(dev) for k, v in (source or {}).items()}
    rows = local_block(torch.arange(b), lay.rows_spec(b, s)[:1], mesh)
    fed = ref_ids[rows].to(dev)
    counting, drops, real = moe_drop_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    logits, coll = [], []
    with torch.inference_mode():
        reset_collective_counts()
        moe._dispatch_row = counting
        t0 = sync_clock(torch)
        try:
            lg, cache, pos = sharded.prefill(
                lay, params, {"tokens": tokens, **source},
                max_cache_len=s + n, dtype=torch.float32)
            res["prefill_ms"] = (sync_clock(torch) - t0) * 1e3
        finally:
            moe._dispatch_row = real
        coll.append(collective_counts())
        logits.append(sharded.gather_logits(lay, lg).cpu())
        step_ms = []
        for t in range(n):
            reset_collective_counts()
            t0 = sync_clock(torch)
            lg, cache = sharded.decode_step(lay, params, cache,
                                            fed[:, t:t + 1], pos,
                                            dtype=torch.float32)
            step_ms.append((sync_clock(torch) - t0) * 1e3)
            coll.append(collective_counts())
            logits.append(sharded.gather_logits(lay, lg).cpu())
            pos = pos + 1
    res.update(rows=rows, logits=logits, collectives=coll, step_ms=step_ms,
               peak=torch.cuda.max_memory_allocated(dev),
               counts=launch_counts(),
               shapes=launch_counts_by_shape()["flash_decode"],
               kv_heads=kv_heads_read(lay),
               drops=[sum(int(k) for k, _ in drops),
                      sum(p for _, p in drops)])
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def per_step(colls) -> str:
    """Collective calls and bytes a step, by kind, from a list of
    ``collective_counts`` (one a step)."""
    kinds = sorted({k for c in colls for k in c})
    n = len(colls)
    def mean(k, what):
        return sum(c.get(k, {}).get(what, 0) for c in colls) / n
    return ", ".join(f"{k} {mean(k, 'calls'):g} calls / "
                     f"{mean(k, 'bytes') / 2**20:.3f} MiB"
                     for k in kinds) or "none"


def check_logits(what, got, want, limit):
    """Every step's logits (this rank's rows) within ``limit`` of
    max|reference|; returns each step's error (the prefill's first)."""
    errs = []
    for t, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not bool(g.isfinite().all()):
            fail(f"{what}: step {t} logits of shape "
                 f"{tuple(g.shape)} (want {tuple(w.shape)}) or non-finite")
        errs.append(float((g - w).abs().max()) / float(w.abs().max()))
        if not errs[-1] <= limit:
            fail(f"{what}: step {t} logits {errs[-1]} of max|logit| > "
                 f"{limit}")
    return errs


def generate_reference(torch, dev, spec, params, tokens, seed):
    """(a)'s reference: the one-process ``generate`` of phase 7's run on
    the same weights: (ids, [logits of each step]) on the host."""
    from repro_torch.launch.serve import generate
    cfg, n = slots_config(spec), spec["steps"]
    ref = []
    t0 = sync_clock(torch)
    ids, t_pre, t_dec = generate(
        cfg, params, tokens, n + 1, logits=ref,
        generator=torch.Generator(device=dev).manual_seed(seed))
    ref = [lg.cpu() for lg in ref]
    say(f"  (a) reference, one process: prefill {t_pre * 1e3:.2f} ms, "
        f"decode {t_dec / n * 1e3:.3f} ms a step "
        f"({sync_clock(torch) - t0:.1f} s with the logits to the host)")
    return ids.cpu(), ref


def mesh_1x1_grid(torch, dev, spec, tokens, ckpt, tmp, seed, ref_ids, ref):
    """(a): phase 7's run on a one-rank NCCL grid through generate(mesh=),
    its blocks restored from the checkpoint, against the reference.
    Returns the run's launches (total, B9's by shape)."""
    import torch.distributed as dist
    from repro_torch.kernels import (launch_counts, launch_counts_by_shape,
                                     reset_launch_counts)
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import collective_counts, reset_collective_counts
    cfg = slots_config(spec)
    n, (b, s) = spec["steps"], tokens.shape
    init_distributed(dev, backend="nccl", init_method=f"file://{tmp}/pg_a",
                     rank=0, world_size=1, timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = make_host_mesh(1, device=dev)
        t0 = sync_clock(torch)
        params = restore_grid(cfg, ckpt, mesh)
        t_restore = sync_clock(torch) - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_collective_counts()
        got = []
        ids, t_pre, t_dec = generate(
            cfg, params, tokens, n + 1, logits=got, mesh=mesh,
            generator=torch.Generator(device=dev).manual_seed(seed))
        counts, shapes = launch_counts(), launch_counts_by_shape()
        run_coll = collective_counts()
        peak = torch.cuda.max_memory_allocated()
        # one prefill and one decode step again, each counted alone
        colls = []
        with torch.inference_mode():
            reset_collective_counts()
            lg, cache, pos = make_prefill_step(
                cfg, s + n, torch.float32, mesh=mesh)(params,
                                                      {"tokens": tokens})
            colls.append(collective_counts())
            reset_collective_counts()
            make_decode_step(cfg, torch.float32, mesh=mesh)(
                params, cache, ids[:, :1], pos)
            colls.append(collective_counts())
        del cache, lg
    finally:
        dist.destroy_process_group()
    if not torch.equal(ids.cpu(), ref_ids):
        bad = int((ids.cpu() != ref_ids).sum())
        fail(f"phase 13 (a): {bad} of {ids.numel()} greedy tokens differ "
             f"from the one-process reference's")
    got = [g.cpu() for g in got]
    worst = max(check_logits("phase 13 (a)", got, ref, spec["limit"]))
    bitwise = all(torch.equal(g, w) for g, w in zip(got, ref))
    b9 = counts["flash_decode"]
    if b9 != cfg.n_layers * n:
        fail(f"phase 13 (a): flash_decode launched {b9} times, not "
             f"{cfg.n_layers} per decode step x {n}")
    kv, g_, d = spec["b9"]
    if any(k[2:5] != (kv, g_, d) for k in shapes["flash_decode"]):
        fail(f"phase 13 (a): B9 at {shapes['flash_decode']}, not at local "
             f"(KV, G, D) = {spec['b9']}")
    say(f"  (a) 1x1 grid over NCCL ({cfg.name}, batch {b}, prompt {s}, "
        f"{n + 1} greedy tokens through generate(mesh=)): restore "
        f"{t_restore:.2f} s; prefill {t_pre * 1e3:.2f} ms, decode "
        f"{t_dec / n * 1e3:.3f} ms a step; peak device memory "
        f"{peak / 2**30:.2f} GiB; tokens equal the reference's; logits "
        f"within {worst:.3g} of max|logit| (limit {spec['limit']:g}), "
        f"bitwise equal: {bitwise}")
    say(f"      B9 {b9 / n:g} launches a decode step, by (B, T, KV, G, D, "
        f"dtype) {shapes['flash_decode']}; collectives over the run "
        f"{run_coll}; a prefill: {per_step(colls[:1])}; a decode step: "
        f"{per_step(colls[1:])}")
    return counts, shapes["flash_decode"]


def mesh_spawned(torch, dev, spec, tokens, ckpt, tmp, ref_ids, ref, label,
                 source=None, ref_drops=None, phase=13, reordered=None):
    """A grid of phase 13 ((b), (c)) or 14: its ranks spawned on the one
    card over gloo, each against the one-process reference on its rows;
    B9's launches a rank (its layers a step x the steps) at the local
    (B/data, KV, G, D) of ``spec['b9']`` (none where it is None); with
    ``ref_drops`` (the reference prefill's (kept, all) MoE pairs) the
    grid's drops, equal on the ranks of a data index and summed over the
    data ranks, against them; with ``reordered`` (``reordered_reference``'s
    logits) the grid's distance from those too (printed).  Returns B9's
    launches over the ranks (total, by shape)."""
    import torch.multiprocessing as mp
    from repro_torch.configs import registry
    from repro_torch.models import model as TM
    cfg = slots_config(spec)
    d, m = spec["grid"]
    world = d * m
    out_dir = Path(tmp) / f"ranks_{label}"
    out_dir.mkdir()
    where = f"phase {phase} ({label})"
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(world, str(dev), f"{tmp}/pg_{label}", spec,
                               ckpt, tokens.cpu(), ref_ids, str(out_dir),
                               source),
             nprocs=world, join=True)
    t_spawn = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    by_step = [0.0] * len(ref)
    b, s = tokens.shape
    n = spec["steps"]
    b9_step = b9_per_step(cfg)
    for r in ranks:
        want = [w[r["rows"]] for w in ref]
        errs = check_logits(f"{where} rank {r['rank']}", r["logits"], want,
                            spec["limit"])
        by_step = [max(a, e) for a, e in zip(by_step, errs)]
        if r["param_bytes"] != r["shard_bytes"]["params"]:
            fail(f"{where}: rank {r['rank']} holds "
                 f"{r['param_bytes']} parameter bytes, shard_bytes says "
                 f"{r['shard_bytes']['params']}")
        b9 = r["counts"]["flash_decode"]
        if b9 != b9_step * n or (spec["b9"] is None) != (b9_step == 0):
            fail(f"{where}: rank {r['rank']} launched B9 {b9} times, not "
                 f"{b9_step} a step x {n}")
        if spec["b9"] is not None and any(
                k[0] != b // d or k[2:5] != spec["b9"] for k in r["shapes"]):
            kv, g_, dd = spec["b9"]
            fail(f"{where}: rank {r['rank']} ran B9 at {r['shapes']}, not "
                 f"at (B {b // d}, KV {kv}, G {g_}, D {dd})")
        first = ranks[r["data_rank"] * m]["drops"]
        if r["drops"] != first:
            fail(f"{where}: rank {r['rank']} kept {r['drops']} MoE pairs, "
                 f"its data index's model rank 0 {first}")
    if ref_drops is not None:
        got = [sum(ranks[i * m]["drops"][j] for i in range(d))
               for j in (0, 1)]
        if b % d:                  # the rows are not split over 'data'
            got = [x // d for x in got]
        if got != list(ref_drops):
            fail(f"{where}: the grid kept {got[0]} of {got[1]} MoE pairs, "
                 f"the reference {ref_drops[0]} of {ref_drops[1]}")
        say(f"  ({label}) MoE pairs of the prefill kept within capacity: "
            f"{got[0]} of {got[1]} on the grid, as the reference")
    if reordered is not None:
        worst = max(max(check_logits(f"{where} rank {r['rank']}", r["logits"],
                                     [w[r["rows"]] for w in reordered], 1.0))
                    for r in ranks)
        say(f"  ({label}) the grid's logits within {worst:.3g} of max|logit| "
            f"of the reordered reference's")
    r0 = ranks[0]
    whole = 4 * TM.count_params(cfg)
    say(f"  ({label}) {d}x{m} grid ({cfg.name}"
        + (f", {cfg.n_layers} of "
           f"{slots_config(dict(spec, layers=None)).n_layers} layers"
           if spec["layers"] else "")
        + (f", encoder {cfg.encoder.n_layers} of "
           f"{registry.get_config(cfg.name).encoder.n_layers} layers"
           if spec.get("encoder_layers") else "")
        + f", batch {b}, prompt {s}, {n} decode steps fed the reference's "
        f"tokens): {world} processes sharing the one card over "
        f"{r0['backend']} (host-staged collectives: these times are of ranks "
        f"sharing one card, not of a grid); spawn to exit {t_spawn:.1f} s, "
        f"restore {max(r['restore_s'] for r in ranks):.1f} s a rank at most")
    say(f"      logits within {max(by_step):.3g} of max|logit| on every "
        f"rank (limit {spec['limit']:g}; the prefill, then each step: "
        + " ".join(f"{e:.2g}" for e in by_step) + "); parameter bytes a rank "
        + ", ".join(str(r["param_bytes"]) for r in ranks)
        + f" = shard_bytes, of {whole} unsharded "
        f"({r0['param_bytes'] / whole:.4f}); kv heads read by the ranks' "
        f"attentions " + str([sorted({str(v) for v in r["kv_heads"].values()})
                             for r in ranks]))
    say(f"      rank 0: prefill {r0['prefill_ms']:.1f} ms, decode "
        f"{sum(r0['step_ms']) / n:.1f} ms a step; peak device memory a "
        f"rank " + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB; B9 {r0['counts']['flash_decode'] / n:g} launches a step "
        f"a rank, by (B, T, KV, G, D, dtype) {r0['shapes']}")
    say(f"      collectives a rank: prefill {per_step(r0['collectives'][:1])};"
        f" a decode step {per_step(r0['collectives'][1:])}")
    counts = {}
    shapes = {}
    for r in ranks:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in r["shapes"].items():
            shapes[k] = shapes.get(k, 0) + v
    return counts, shapes


def phase_mesh(torch, dev, seed):
    """Phase 13: the dense LMs on (data, model) grids of ranks, each grid
    against the one-process port on the same weights (run first, its
    logits to the host, its memory freed before the grid starts).
    Returns B9's launches (total, by shape) over the grids."""
    import shutil
    import tempfile
    say(f"== phase 13: the dense LMs served on (data, model) grids of ranks "
        f"(f32, seeded random weights at std 1/sqrt(fan-in)) ({card_line()})")
    t_start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        check_disk(tmp, MESH_DISK_GIB, "phase 13")
        # gemma3-1b: (a) and (c)'s references, then one checkpoint for both
        a, c = MESH["a"], MESH["c"]
        cfg = slots_config(a)
        gen = torch.Generator(device=dev).manual_seed(seed + 13)
        tok_a = torch.randint(0, cfg.vocab_size, (a["batch"], a["prompt"]),
                              generator=gen, device=dev)
        tok_c = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"]),
                              generator=gen, device=dev)
        params = fan_in_init(torch, cfg, dev, seed)
        ref_a = generate_reference(torch, dev, a, params, tok_a, seed)
        t0 = sync_clock(torch)
        ref_c = mesh_reference(torch, cfg, params, tok_c, c["steps"])
        say(f"  (c) reference, one process: {sync_clock(torch) - t0:.2f} s")
        ckpt = write_checkpoint(params, f"{tmp}/{cfg.name}")
        del params
        torch.cuda.empty_cache()
        out["a"] = mesh_1x1_grid(torch, dev, a, tok_a, ckpt, tmp, seed,
                                 *ref_a)
        del ref_a
        torch.cuda.empty_cache()
        out["c"] = mesh_spawned(torch, dev, c, tok_c, ckpt, tmp, *ref_c,
                                "c")
        shutil.rmtree(ckpt)
        # qwen3-14b, 8 of its 40 layers
        b = MESH["b"]
        cfg = slots_config(b)
        tok_b = torch.randint(0, cfg.vocab_size, (b["batch"], b["prompt"]),
                              generator=gen, device=dev)
        params = fan_in_init(torch, cfg, dev, seed)
        t0 = sync_clock(torch)
        ref_b = mesh_reference(torch, cfg, params, tok_b, b["steps"])
        say(f"  (b) reference, one process: {sync_clock(torch) - t0:.2f} s")
        ckpt = write_checkpoint(params, f"{tmp}/{cfg.name}")
        del params
        torch.cuda.empty_cache()
        out["b"] = mesh_spawned(torch, dev, b, tok_b, ckpt, tmp, *ref_b, "b")
    total, shapes = summed_launches(out.values())
    say(f"  phase 13 {time.perf_counter() - t_start:.1f} s; B9 launches "
        f"over the grids {total.get('flash_decode', 0)}")
    return total, shapes


def summed_launches(runs):
    """(launches by kernel, B9's by shape) summed over the grids' runs."""
    total, shapes = {}, {}
    for counts, by_shape in runs:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        for k, v in by_shape.items():
            shapes[k] = shapes.get(k, 0) + v
    return total, shapes


# ---------------------------------------------------------------------------
# phase 14: the other slot kinds on (data, model) grids of ranks
# ---------------------------------------------------------------------------

# Each grid is four processes sharing the card over gloo, its blocks
# restored from one checkpoint of the model, fed the one-process
# reference's greedy tokens.  mixtral-8x22b cut to 1 of 56 layers (10 GB
# a layer in f32) holds 2 experts a rank; zamba2-7b is cut to
# 3 of its 27 periods (9 of 81 layers; FSDP's gathers go through the host)
# and runs 56 ssm heads a rank; rwkv6-1.6b 8 heads a rank; whisper-large-v3
# its encoder over 1500 frames and cross attention, 10 heads a rank, the
# vocab split at model 2.  ``b9``: the local (KV, G, D) B9 must run at
# (None: no kernel on the path); ``limit``: the logits' limit of
# max|logit| against the reference on the same weights; ``reorder``: the
# reference is run again with rwkv6's row-parallel products summed from
# that many row blocks (``split_row_products``), to read how far a change
# of summation order alone moves the logits.
SLOT_GRIDS = dict(
    a=dict(arch="mixtral-8x22b", layers=1, grid=(1, 4), batch=4, prompt=512,
           steps=2, b9=(2, 6, 128), limit=2e-3),
    b=dict(arch="zamba2-7b", layers=6, grid=(2, 2), batch=4, prompt=512,
           steps=2, b9=(16, 1, 112), limit=2e-3),
    c=dict(arch="rwkv6-1.6b", layers=8, grid=(1, 4), batch=4, prompt=512,
           steps=4, b9=None, limit=2e-3, reorder=4),
    d=dict(arch="whisper-large-v3", layers=8, encoder_layers=8,
           grid=(2, 2), batch=4, prompt=448, steps=2, b9=(10, 1, 64),
           limit=2e-3))


def reordered_reference(torch, cfg, params, tokens, steps, source, ref_ids,
                        ref, parts, label):
    """The reference run again with ``split_row_products(parts)``, fed the
    reference's tokens: its logits on the host, and how far each step's
    are from the reference's (printed, not a check)."""
    t0 = sync_clock(torch)
    undo = split_row_products(parts)
    try:
        _, got = mesh_reference(torch, cfg, params, tokens, steps, source,
                                fed=ref_ids)
    finally:
        undo()
    errs = check_logits(f"phase 14 ({label}) reordered reference", got, ref,
                        1.0)
    say(f"  ({label}) the reference with rwkv6's w_o and w_cv products summed"
        f" from {parts} row blocks: logits within {max(errs):.3g} of "
        f"max|logit| of the reference (the prefill, then each step: "
        + " ".join(f"{e:.2g}" for e in errs)
        + f"); {sync_clock(torch) - t0:.2f} s")
    return got


def split_row_products(parts):
    """Patches rwkv6's time mix and channel mix so that their row-parallel
    products (``w_o`` over the heads, ``w_cv`` over the mlp rows) are each
    summed from ``parts`` partial products of contiguous row blocks, left
    to right, as a 1 x ``parts`` grid sums them; everything else is the
    one-process port's arithmetic.  Each block's product is the whole
    product with the other rows zero (adding exact zeros rounds nothing).
    Returns a function that undoes the patch."""
    import torch
    from repro_torch.models import rwkv6 as rw
    real = rw.time_mix, rw.channel_mix

    def split(fn, leaf):
        def run(params, x, **kw):
            w, partial = params[leaf], []
            rows = w.shape[0] // parts

            def total(t):
                partial.append(t)
                out = partial[0]
                for p in partial[1:]:
                    out = out + p
                return out
            for i in range(parts):
                block = torch.zeros_like(w)
                block[i * rows:(i + 1) * rows] = w[i * rows:(i + 1) * rows]
                out = fn(dict(params, **{leaf: block}), x, total=total, **kw)
            return out
        return run
    rw.time_mix = split(real[0], "w_o")
    rw.channel_mix = split(real[1], "w_cv")

    def undo():
        rw.time_mix, rw.channel_mix = real
    return undo


def phase_slot_grids(torch, dev, seed, grids=None):
    """Phase 14: MoE, mamba2 with the shared attention, rwkv6 and the
    encoder-decoder on (data, model) grids of ranks (``SLOT_GRIDS``), each
    against the one-process port on the same weights (run first, its
    logits to the host, its memory freed before the grid starts) and the
    MoE pairs its prefill dropped.  Returns B9's launches (total, by
    shape) over the grids.  ``grids``: other grids than ``SLOT_GRIDS``
    (``tools/mesh_serving.py --slot-grids``)."""
    import shutil
    import tempfile
    from repro_torch.launch.steps import source_inputs
    from repro_torch.models import model as TM
    from repro_torch.models import moe
    say(f"== phase 14: the other slot kinds served on (data, model) grids "
        f"of ranks (f32, seeded random weights at std 1/sqrt(fan-in)) "
        f"({card_line()})")
    t_start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slots_") as tmp:
        for label, spec in (grids or SLOT_GRIDS).items():
            cfg = slots_config(spec)
            b, s, n = spec["batch"], spec["prompt"], spec["steps"]
            gen = torch.Generator(device=dev).manual_seed(seed + 14)
            tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device=dev)
            source = source_inputs(cfg, b, gen)
            params = fan_in_init(torch, cfg, dev, seed)
            counting, drops, real = moe_drop_counter()
            moe._dispatch_row = counting
            t0 = sync_clock(torch)
            try:
                ref_ids, ref = mesh_reference(torch, cfg, params, tokens, n,
                                              source)
            finally:
                moe._dispatch_row = real
            ref_drops = None
            if cfg.moe is not None:
                ref_drops = (sum(int(k) for k, _ in drops),
                             sum(p for _, p in drops))
            say(f"  ({label}) reference, one process: "
                f"{sync_clock(torch) - t0:.2f} s")
            if spec.get("reorder"):
                reordered = reordered_reference(torch, cfg, params, tokens,
                                                n, source, ref_ids, ref,
                                                spec["reorder"], label)
            check_disk(tmp, round(4 * TM.count_params(cfg) / 2**30 + 1, 1),
                       f"phase 14 ({label})")
            ckpt = write_checkpoint(params, f"{tmp}/{cfg.name}")
            del params
            torch.cuda.empty_cache()
            out[label] = mesh_spawned(
                torch, dev, spec, tokens, ckpt, tmp, ref_ids, ref, label,
                source={k: v.cpu() for k, v in source.items()},
                ref_drops=ref_drops, phase=14,
                reordered=reordered if spec.get("reorder") else None)
            shutil.rmtree(ckpt)
            del tokens, source, ref
            torch.cuda.empty_cache()
    total, shapes = summed_launches(out.values())
    say(f"  phase 14 {time.perf_counter() - t_start:.1f} s; B9 launches "
        f"over the grids {total.get('flash_decode', 0)}")
    return total, shapes


# ---------------------------------------------------------------------------
# phase 15: the LM train step on (data, model) grids of ranks
# ---------------------------------------------------------------------------

TRAIN_MESH = dict(
    a=dict(arch="gemma3-1b", grid=(1, 1), batch=8, seq=2048, steps=3,
           dtype="bfloat16", limit=1e-4),
    b=dict(arch="gemma3-1b", layers=6, grid=(2, 2), batch=4, seq=512,
           steps=1, dtype="float32", limit=1e-5))
TRAIN_MESH_OPT = dict(lr=3e-4, warmup_steps=0, total_steps=12)
TRAIN_MESH_DISK_GIB = 12  # (b)'s 5.6 GB train state, the ranks' 3.7 GB of
                          # blocks


def _host_tree(tree) -> dict:
    """{tree_leaves path: the leaf on the host}."""
    from repro_torch.models.params import tree_leaves
    return {p: t.detach().cpu() for p, t in tree_leaves(tree)}


def adamw_rule(what, got: dict, want: dict, grads: dict, lr: float,
               scale: float) -> tuple[int, float]:
    """Phase 11's AdamW rule on {path: tensor} trees: the updated
    parameters within lr x 1e-3 of ``want`` where the gradient AdamW
    takes (``grads`` times the clip ``scale``) is above 1e-5 (its first
    step is sign noise where that is near eps), all finite.  Returns (the
    entries compared, the largest distance there over lr); fails the run
    on a non-finite entry only (the caller gates the distance)."""
    n, worst = 0, 0.0
    for p, a in got.items():
        b, g = want[p].to(a.device), grads[p].to(a.device)
        if not bool(a.isfinite().all()):
            fail(f"{what}: {p} non-finite after the step")
        big = g.abs() * scale > 1e-5
        if bool(big.any()):
            worst = max(worst, float((a - b).abs()[big].max()) / lr)
        n += int(big.sum())
    return n, worst


def train_mesh_1x1(torch, dev, seed):
    """(a): gemma3-1b uncut, bf16 compute, float32 master weights and
    AdamW state, the init's own draws; the one-process train step first,
    3 steps, its metrics, the gradient of the first batch and the
    parameters after the first step moved to the host; then the same 3
    steps on a one-rank NCCL grid from ``init_train_state(mesh=)``.  Both
    run under ``torch.use_deterministic_algorithms`` (warnings only, for
    cuBLAS's workspace setting), so the embedding backward's atomic adds
    cannot reorder: at the init's std-1 stacked weights the step is
    chaotic, and a difference in the last bits of step 1's gradient
    moved step 2's grad norm by 9 % and step 3's by 24 % (this phase's
    first runs on the card, PERF.md).  Returns the grid run's
    launches."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _train_mesh_1x1(torch, dev, seed)
    finally:
        torch.use_deterministic_algorithms(False)


def _train_mesh_1x1(torch, dev, seed):
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import specs
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import (collective_counts,
                                      reset_collective_counts)
    spec = TRAIN_MESH["a"]
    cfg = registry.get_config(spec["arch"])
    b, s, n = spec["batch"], spec["seq"], spec["steps"]
    dtype = getattr(torch, spec["dtype"])
    opt_cfg = AdamWConfig(**TRAIN_MESH_OPT)
    batches = [synthetic_lm_batch(seed, k, batch=b, seq=s,
                                  vocab=cfg.vocab_size, device=dev)
               for k in range(n)]
    draw = lambda: torch.Generator(device=dev).manual_seed(seed + 15)
    state = TS.init_train_state(cfg, draw())
    grads = _host_tree(TS.make_grad_step(cfg, dtype)(state[0],
                                                     batches[0])[1])
    torch.cuda.empty_cache()
    one = TS.make_train_step(cfg, opt_cfg, dtype)
    ref, ref_ms, p, o = [], [], state[0], state[1]
    for k in range(n):
        t0 = sync_clock(torch)
        p, o, m = one(p, o, batches[k])
        ref_ms.append((sync_clock(torch) - t0) * 1e3)
        ref.append({key: float(v) for key, v in m.items()})
        if k == 0:
            p1 = _host_tree(p)
    del p, o, m
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_a_")
    init_distributed(dev, backend="nccl", init_method=f"file://{tmp}/pg",
                     rank=0, world_size=1, timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = make_host_mesh(1, device=dev)
        gp, go = TS.init_train_state(cfg, draw(), mesh=mesh)
        same = all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(tree_leaves(gp), tree_leaves(state[0])))
        del state
        if not same:
            fail("phase 15 (a): init_train_state(mesh=) on 1x1 is not the "
                 "one-process draw")
        step = TS.make_train_step(cfg, opt_cfg, dtype, mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        got, ms, colls = [], [], []
        for k in range(n):
            reset_collective_counts()
            t0 = sync_clock(torch)
            gp, go, m = step(gp, go, batches[k])
            ms.append((sync_clock(torch) - t0) * 1e3)
            colls.append(collective_counts())
            got.append({key: float(v) for key, v in m.items()})
            if k == 0:
                compared, moved = adamw_rule(
                    "phase 15 (a) step 1", dict(tree_leaves(gp)), p1, grads,
                    m["lr"].item(), min(1.0, opt_cfg.clip_norm /
                                        ref[0]["grad_norm"]))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        cols = specs.shard_bytes(cfg, ShapeSpec("train", s, b, "train"),
                                 mesh)
        del gp, go, m
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    del p1, grads
    torch.cuda.empty_cache()
    rel = lambda x, y: abs(x - y) / abs(y)
    bitwise = all(g[key] == w[key] for g, w in zip(got, ref)
                  for key in ("loss", "grad_norm"))
    step_ms = sum(ms[1:]) / (n - 1)
    ref_step = sum(ref_ms[1:]) / (n - 1)
    flops = specs.useful_flops(cfg, ShapeSpec("train", s, b, "train"))
    say(f"  (a) {cfg.name} uncut on a 1x1 grid over NCCL (bf16 compute, "
        f"float32 master weights and AdamW state; batch {b} x {s}, {n} "
        f"steps from one state; deterministic algorithms; {card_line()}): "
        f"step, loss, grad norm "
        f"(grid / one process): " + "; ".join(
            f"{k + 1} {g['loss']:.6f} / {w['loss']:.6f}, "
            f"{g['grad_norm']:.6f} / {w['grad_norm']:.6f}"
            for k, (g, w) in enumerate(zip(got, ref)))
        + f"; within {max(rel(g[k_], w[k_]) for g, w in zip(got, ref) for k_ in ('loss', 'grad_norm')):.3g} "
        f"relative (limit {spec['limit']:g}), bitwise: {bitwise}; the "
        f"parameters after step 1 within {moved:.3g} lr of the "
        f"one-process update where the clipped |g| > 1e-5 ({compared} "
        f"entries; limit 1e-3 lr)")
    say(f"      ms a step after the first: grid {step_ms:.1f} (each "
        + ", ".join(f"{t:.1f}" for t in ms) + f"), one process "
        f"{ref_step:.1f} (each " + ", ".join(f"{t:.1f}" for t in ref_ms)
        + f"); {b * s / step_ms * 1e3:.0f} tokens/s on the grid; MFU "
        f"{flops / (step_ms * 1e-3) / PEAK_BF16_OPS_PER_S:.1%} "
        f"(launch.specs.useful_flops {flops / 1e12:.2f} TFLOP a step over "
        f"the dense bf16 peak); peak device memory {peak / 2**30:.2f} GiB "
        f"against shard_bytes {cols['total'] / 2**30:.2f} GiB (params "
        f"{cols['params'] / 2**30:.2f}, opt_state "
        f"{cols['opt_state'] / 2**30:.2f}, batch {cols['batch']} B; the "
        f"rest: gradients, the update's new state, activations)")
    say(f"      collectives a step: {per_step(colls[1:])}; kernel launches "
        f"in the grid's run: {counts}")
    for k, (g, w) in enumerate(zip(got, ref)):
        for key in ("loss", "grad_norm"):
            if not rel(g[key], w[key]) <= spec["limit"]:
                fail(f"phase 15 (a): step {k + 1} {key} {g[key]} against "
                     f"the one-process {w[key]} (limit {spec['limit']:g} "
                     f"relative)")
    if not moved <= 1e-3:
        fail(f"phase 15 (a): the parameters after step 1 {moved} lr from "
             f"the one-process update where the clipped |g| > 1e-5")
    if any(counts.values()):
        fail(f"phase 15 (a): kernels launched in training: {counts}")
    return counts


def _train_rank(rank, world, device, store, spec, ckpt, batches, out_dir):
    """One rank of (b), in its own process: a gloo group on ``device``
    (four ranks share the card), its train state restored from the
    checkpoint by ``param_shardings`` and ``opt_shardings``; the gradient
    of the first batch, then the train steps.  Writes its record (metrics,
    gradient and parameter blocks on the host, memory, collectives,
    launches) to out_dir."""
    sys.path.insert(0, str(REPO / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_resharded
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import specs
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import (collective_counts,
                                      reset_collective_counts)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(torch.device(device), backend="gloo",
                           init_method=f"file://{store}", rank=rank,
                           world_size=world, timeout_s=MESH_TIMEOUT_S)
    mesh = make_host_mesh(spec["grid"][1], device=dev)
    cfg = slots_config(spec)
    dtype = getattr(torch, spec["dtype"])
    t0 = time.perf_counter()
    state, _, _ = restore_resharded(ckpt, specs.abstract_train_state(cfg),
                                    specs.train_state_placement(cfg, mesh),
                                    mesh)
    params, opt = state["params"], state["opt"]
    res = dict(rank=rank, data_rank=mesh.data_rank,
               model_rank=mesh.model_rank, backend=dist.get_backend(),
               restore_s=time.perf_counter() - t0)
    res["held"] = sum(t.numel() * t.element_size() for _, t in tree_leaves(
        {"p": params, "m": opt.m, "v": opt.v, "step": opt.step}))
    b, s = batches[0]["tokens"].shape
    res["shard_bytes"] = specs.shard_bytes(
        cfg, ShapeSpec("train", s, b, "train"), mesh)
    batches = [{k: v.to(dev) for k, v in bt.items()} for bt in batches]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    _, g = TS.make_grad_step(cfg, dtype, mesh=mesh)(params, batches[0])
    res["grads"] = _host_tree(g)
    del g
    step = TS.make_train_step(cfg, AdamWConfig(**TRAIN_MESH_OPT), dtype,
                              mesh=mesh)
    res.update(metrics=[], ms=[], collectives=[])
    for k, bt in enumerate(batches):
        reset_collective_counts()
        t0 = sync_clock(torch)
        params, opt, m = step(params, opt, bt)
        res["ms"].append((sync_clock(torch) - t0) * 1e3)
        res["collectives"].append(collective_counts())
        res["metrics"].append({key: float(v) for key, v in m.items()})
        if k == 0:
            res["params"] = _host_tree(params)
    res.update(peak=torch.cuda.max_memory_allocated(dev),
               counts=launch_counts())
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def train_mesh_2x2(torch, dev, seed):
    """(b): gemma3-1b cut to 6 layers on a 2x2 grid, four processes on the
    one card over gloo, f32, weights from the seed at std 1/sqrt(fan-in);
    the one-process reference on the card first (the gradient of the first
    batch, the parameters after step 1 and each step's metrics, to the
    host), the state checkpointed once and restored by every rank.
    Returns the ranks' launches summed."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import specs
    from repro_torch.launch import steps as TS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import local_block
    spec = TRAIN_MESH["b"]
    cfg = slots_config(spec)
    (d, m), (b, s), n = spec["grid"], (spec["batch"], spec["seq"]), \
        spec["steps"]
    dtype = getattr(torch, spec["dtype"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_b_")
    try:
        check_disk(tmp, TRAIN_MESH_DISK_GIB, "phase 15 (b)")
        params = fan_in_init(torch, cfg, dev, seed + 15)
        opt = adamw_init(params)
        batches = [synthetic_lm_batch(seed + 1, k, batch=b, seq=s,
                                      vocab=cfg.vocab_size, device=dev)
                   for k in range(n)]
        t0 = sync_clock(torch)
        grads = _host_tree(TS.make_grad_step(cfg, dtype)(params,
                                                         batches[0])[1])
        opt_cfg = AdamWConfig(**TRAIN_MESH_OPT)
        one = TS.make_train_step(cfg, opt_cfg, dtype)
        ref, p, o = [], params, opt
        for k in range(n):
            p, o, mt = one(p, o, batches[k])
            ref.append({key: float(v) for key, v in mt.items()})
            if k == 0:
                p1 = _host_tree(p)
        del p, o, mt
        t_ref = sync_clock(torch) - t0
        t0 = time.perf_counter()
        ckpt = save_checkpoint(f"{tmp}/state", 0, {"params": params,
                                                   "opt": opt})
        t_save = time.perf_counter() - t0
        del params, opt
        torch.cuda.empty_cache()
        out_dir = Path(tmp) / "ranks"
        out_dir.mkdir()
        t0 = time.perf_counter()
        mp.spawn(_train_rank, args=(
            d * m, str(dev), f"{tmp}/pg", spec, str(Path(ckpt).parent),
            [{k: v.cpu() for k, v in bt.items()} for bt in batches],
            str(out_dir)), nprocs=d * m, join=True)
        t_spawn = time.perf_counter() - t0
        counts, ranks, worst_g, worst_p = {}, [], 0.0, 0.0
        for r in range(d * m):
            rec = torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            where = f"phase 15 (b) rank {r}"
            fm = Mesh(d, m, rec["data_rank"], rec["model_rank"], None, None,
                      torch.device("cpu"))
            pspec = dict(specs.train_state_placement(cfg, fm))
            cut = lambda tree: {p_: local_block(t, pspec[f"['params']{p_}"],
                                                fm)
                                for p_, t in tree.items()}
            for p_, g in rec["grads"].items():
                want = local_block(grads[p_], pspec[f"['params']{p_}"], fm)
                err = float((g - want).abs().max()) / (
                    float(grads[p_].abs().max()) + 1e-30)
                worst_g = max(worst_g, err)
                if not err <= 1e-4:
                    fail(f"{where}: gradient of {p_} {err} of the leaf's "
                         f"max|g| from the one-process port's (limit 1e-4)")
            _, moved = adamw_rule(where, rec["params"], cut(p1), cut(grads),
                                  rec["metrics"][0]["lr"], min(
                                      1.0, opt_cfg.clip_norm / ref[0][
                                          "grad_norm"]))
            worst_p = max(worst_p, moved)
            if not moved <= 1e-3:
                fail(f"{where}: the parameters after step 1 {moved} lr from "
                     f"the one-process update where the clipped |g| > 1e-5")
            for k, (g, w) in enumerate(zip(rec["metrics"], ref)):
                for key, lim in (("loss", spec["limit"]),
                                 ("grad_norm", 1e-4)):
                    if not abs(g[key] - w[key]) <= lim * abs(w[key]):
                        fail(f"{where}: step {k + 1} {key} {g[key]} against "
                             f"the one-process {w[key]} (limit {lim:g})")
            if rec["held"] != rec["shard_bytes"]["params"] + \
                    rec["shard_bytes"]["opt_state"]:
                fail(f"{where}: holds {rec['held']} bytes of train state, "
                     f"shard_bytes says {rec['shard_bytes']['params']} + "
                     f"{rec['shard_bytes']['opt_state']}")
            for key, v in rec["counts"].items():
                counts[key] = counts.get(key, 0) + v
            del rec["grads"], rec["params"]
            ranks.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(counts.values()):
        fail(f"phase 15 (b): kernels launched in training: {counts}")
    r0 = ranks[0]
    say(f"  (b) {cfg.name}, {cfg.n_layers} of "
        f"{registry.get_config(cfg.name).n_layers} layers, on a {d}x{m} "
        f"grid: {d * m} processes "
        f"sharing the one card over {r0['backend']} (host-staged "
        f"collectives: times of ranks sharing one card, not of a grid); "
        f"f32, fan-in weights from the seed, batch {b} x {s} ({b // d} rows "
        f"a data rank), {n} steps; reference on the card {t_ref:.1f} s, "
        f"the train state checkpointed in {t_save:.1f} s, spawn to exit "
        f"{t_spawn:.1f} s, restore {max(r['restore_s'] for r in ranks):.1f}"
        f" s a rank at most ({card_line()})")
    say(f"      loss and grad norm on every rank / one process: "
        + "; ".join(f"step {k + 1} {r0['metrics'][k]['loss']:.6f} / "
                    f"{w['loss']:.6f}, {r0['metrics'][k]['grad_norm']:.6f} "
                    f"/ {w['grad_norm']:.6f}" for k, w in enumerate(ref))
        + f"; gradient blocks within {worst_g:.3g} of each leaf's max|g| "
        f"(limit 1e-4); parameters after step 1 within {worst_p:.3g} lr of "
        f"the one-process update where the clipped |g| > 1e-5 (limit "
        f"1e-3)")
    say(f"      a rank: train state held " + ", ".join(
        str(r["held"]) for r in ranks) + " B = shard_bytes' params + "
        f"opt_state; peak device memory " + ", ".join(
            f"{r['peak'] / 2**30:.2f}" for r in ranks) + " GiB; rank 0 "
        f"ms a step " + ", ".join(f"{t:.0f}" for t in r0["ms"])
        + f"; collectives a step {per_step(r0['collectives'])}")
    return counts


def phase_train_mesh(torch, dev, seed):
    """Phase 15: the LM train step on (data, model) grids of ranks, each
    against the one-process port's step on the card.  Returns the
    kernels' launches over the grids' runs (none: training attends over
    the full sequence)."""
    say(f"== phase 15: the LM train step on (data, model) grids of ranks "
        f"({card_line()})")
    t_start = time.perf_counter()
    counts = train_mesh_1x1(torch, dev, seed)
    for k, v in train_mesh_2x2(torch, dev, seed).items():
        counts[k] = counts.get(k, 0) + v
    say(f"  phase 15 {time.perf_counter() - t_start:.1f} s; kernel "
        f"launches over the grids {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 16: the dry run
# ---------------------------------------------------------------------------

# (b)'s peak band: the dry run's arguments plus peak against the card's,
# written in PERF.md before the run that held it
DRYRUN_PEAK_BAND = 0.05
# how long phase 16 waits for dry runs still going when it starts
DRYRUN_TIMEOUT_S = 300.0
# dry runs at once beside phases 1-10: the card's host has 8 cores, and
# the build's nvcc and the phases' own process need the rest
DRYRUN_LANES = 6
# (b)'s runs: phase 15 (a)'s train step, phase 7's decode step and phase
# 6's psum step, each on a 1x1 grid
CALIBRATION = {
    "train": dict(arch="gemma3-1b", kind="train", batch=8, seq=2048,
                  dtype="bfloat16"),
    "decode": dict(arch="gemma3-1b", kind="decode", batch=8, seq=2112,
                   dtype="float32"),
    "krr": dict(shape="krr_4m"),
}


def dryrun_jobs(tmp: str):
    """(label, argv, log path, cells) of phase 16's processes: (b)'s dry
    runs (this script with ``--calibration-dry-run``), then for (a) one
    ``python -m repro_torch.launch.dryrun`` a (mesh, arch), the largest
    models first, and one a (mesh, KRR variant): the cells of ``--mesh
    both --cells all`` and of ``--cells krr --krr-variant hashjoin``."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import matmul_params
    stem = lambda label: f"{tmp}/{label.replace(' ', '_')}"
    jobs = [("calibration", [sys.executable, str(REPO / "chip_smoke.py"),
                             "--calibration-dry-run",
                             f"{tmp}/calibration.json"],
             f"{tmp}/calibration.log", 0)]

    def add(label, args, cells):
        jobs.append((label, [sys.executable, "-m", "repro_torch.launch.dryrun",
                             *args, "--out", f"{stem(label)}.jsonl"],
                     f"{stem(label)}.log", cells))
    archs = sorted(registry.ARCH_IDS, key=lambda a: -matmul_params(
        registry.get_config(a))[1])
    for arch in archs:
        n = len(list(dryrun.iter_cells("lm", arch, None)))
        for mesh in ("pod", "multipod"):
            add(f"{arch} {mesh}", ["--mesh", mesh, "--cells", "lm", "--arch",
                                   arch], n)
    for variant in ("psum", "hashjoin"):
        for mesh in ("pod", "multipod"):
            add(f"wlsh_krr {variant} {mesh}", ["--mesh", mesh, "--cells",
                                               "krr", "--krr-variant",
                                               variant], 2)
    return jobs


@contextlib.contextmanager
def dryruns():
    """Phase 16's dry runs (``dryrun_jobs``), a process each, started on
    entry, before the build, ``DRYRUN_LANES`` at a time: they need no card
    and run beside the earlier phases on the cores those leave idle (all
    at once, even at nice 19, they slowed the build's nvcc threefold on
    the card's host).  Yields (jobs, futures of their exit codes, start
    time); on exit cancels the jobs not started, kills those running and
    removes their files."""
    import os
    import shutil
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    jobs, running = dryrun_jobs(tmp), set()
    lock, stopping = threading.Lock(), threading.Event()

    def run(argv, log):
        with lock:
            if stopping.is_set():
                return None
            with open(log, "w") as fh:
                proc = subprocess.Popen(argv, stdout=fh,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=REPO)
            running.add(proc)
        rc = proc.wait()
        with lock:
            running.discard(proc)
        return rc

    pool = ThreadPoolExecutor(DRYRUN_LANES)
    try:
        t0 = time.time()
        yield jobs, [pool.submit(run, argv, log)
                     for _, argv, log, _ in jobs], t0
    finally:
        with lock:
            stopping.set()
            for proc in running:
                proc.kill()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)


def calibration_cell(name, mesh):
    """(b)'s cell ``name`` of ``CALIBRATION`` on ``mesh`` (the dry run's
    own lowering: the step built as the dry run builds it, meta
    arguments)."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    spec = CALIBRATION[name]
    if name == "krr":
        return dryrun.lower_krr_cell(spec["shape"], mesh, "psum")
    shape = ShapeSpec(name, spec["seq"], spec["batch"], spec["kind"])
    return dryrun.lower_lm_cell(spec["arch"], shape, mesh, micro=1,
                                dtype=getattr(torch, spec["dtype"]))


def calibration_dry_runs(path: str) -> None:
    """(b)'s dry runs, on a fake 1x1 grid in a process of their own (the
    fake group cannot live beside NCCL): each cell's counts, arguments and
    peak, as JSON to ``path``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_grid
    out = {}
    with fake_grid(1, 1) as mesh:
        for name in CALIBRATION:
            t0 = time.perf_counter()
            cell = calibration_cell(name, mesh)
            trace, out_bytes = dryrun.trace_cell(cell)
            out[name] = dict(summary=trace.summary(), arg=cell.arg_bytes,
                             peak=trace.peak_bytes, out=out_bytes,
                             stand_ins=trace.stand_ins,
                             seconds=time.perf_counter() - t0)
    with open(path, "w") as fh:
        json.dump(out, fh)


def calibration_args(torch, name, cell, mesh, data, seed):
    """Real arguments on the card of (b)'s cell ``name``, of the shapes and
    dtypes of its dry run's meta arguments."""
    from repro_torch import core as T
    from repro_torch.configs import registry
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import steps as TS
    from repro_torch.launch.serve import init_local
    from repro_torch.models import model as TM
    from repro_torch.models.sharded import ShardedCache
    dev = mesh.device
    spec = CALIBRATION[name]
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    if name == "krr":
        x, y, lsh = cell.args
        rng = np.random.default_rng(seed + 16)
        return (data[0][:x.shape[0]], data[1][:y.shape[0]],
                T.sample_lsh_params(rng, lsh.w.shape[0], lsh.w.shape[1],
                                    T.GammaPDF(2.0, 1.0), device=dev))
    cfg = registry.get_config(spec["arch"])
    b, s = spec["batch"], spec["seq"]
    if name == "train":
        params, opt = TS.init_train_state(cfg, gen, mesh=mesh)
        batch = {k: v.to(torch.int32) for k, v in synthetic_lm_batch(
            seed, 0, batch=b, seq=s, vocab=cfg.vocab_size,
            device=dev).items()}
        return params, opt, batch
    dtype = getattr(torch, spec["dtype"])
    params = init_local(cfg, mesh, gen, dtype)
    cache = ShardedCache(TM.init_cache(cfg, b, s, dtype, device=dev), b, s)
    return (params, cache, torch.zeros((b, 1), dtype=torch.int32, device=dev),
            torch.full((b,), s - 64, dtype=torch.int32, device=dev))


def calibration_runs(torch, dev, data, seed, tmp: str) -> dict:
    """(b)'s runs on the card, each traced on a one-rank NCCL grid (its
    store under ``tmp``): {name: counts, arguments, the growth of
    ``max_memory_allocated``, stand-ins, seconds}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.roofline import Tracer
    init_distributed(dev, backend="nccl", init_method=f"file://{tmp}/pg",
                     rank=0, world_size=1, timeout_s=MESH_TIMEOUT_S)
    real = {}
    try:
        mesh = make_host_mesh(1, device=dev)
        for name in CALIBRATION:
            cell = calibration_cell(name, mesh)
            args = calibration_args(torch, name, cell, mesh, data, seed)
            grad = contextlib.nullcontext() if cell.train \
                else torch.inference_mode()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = sync_clock(torch)
            with grad, Tracer() as tracer:
                out = cell.step(*args)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            growth = torch.cuda.max_memory_allocated() - base
            real[name] = dict(summary=json.loads(json.dumps(
                tracer.trace.summary())), arg=cell.arg_bytes, growth=growth,
                stand_ins=tracer.trace.stand_ins, seconds=seconds)
            del out, args, tracer
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return real


def dryrun_results(jobs, futures) -> list[dict]:
    """Waits up to ``DRYRUN_TIMEOUT_S`` for phase 16's processes; fails
    unless each exited 0 and printed a line a cell.  Returns (a)'s rows."""
    from concurrent.futures import wait
    if wait(futures, timeout=DRYRUN_TIMEOUT_S).not_done:
        fail(f"phase 16: the dry runs did not end within "
             f"{DRYRUN_TIMEOUT_S} s of the phase's start")
    rows, failed = [], []
    for (label, _, log, cells), fut in zip(jobs, futures):
        text = Path(log).read_text()
        if fut.result() != 0:
            failed.append(f"{label}: rc {fut.result()}: {text[-2000:]}")
            continue
        if label == "calibration":
            continue
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("[dryrun] ") and ": trace " in ln]
        if len(lines) != cells:
            failed.append(f"{label}: {len(lines)} cells of {cells}")
            continue
        jsonl = Path(log[:-len(".log")] + ".jsonl")
        rows += [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    if failed:
        fail("phase 16 (a): dry runs failed:\n" + "\n".join(failed))
    return rows


def phase_dryrun(torch, dev, data, seed, sweep):
    """16. The dry run (see the module docstring); ``sweep`` is what
    ``dryruns`` yields."""
    from repro_torch.configs.wlsh_krr import CONFIG as KRR
    from repro_torch.core import RECT, GammaPDF, sample_lsh_params
    from repro_torch.core.operator import WLSHOperator
    from repro_torch.kernels.binning import ops as BO
    from repro_torch.roofline import Tracer, materializes_shape
    say(f"== phase 16: the dry run (launch.dryrun, roofline) "
        f"({card_line()})")
    t_phase = time.perf_counter()
    jobs, futures, t_sweep = sweep
    real = calibration_runs(torch, dev, data, seed,
                            str(Path(jobs[0][2]).parent))

    # (c) the fused matvec at phase 3's shapes makes no (m, B) table
    n, m, b = KRR.n_points, KRR.m, KRR.table_size
    lsh = sample_lsh_params(np.random.default_rng(seed), m, KRR.dim,
                            GammaPDF(2.0, 1.0), device=dev)
    op = WLSHOperator(lsh=lsh, bucket=RECT, table_size=b, fused=True)
    idx = op.build_index(op.featurize(data[0][:n]), blocked=True)
    with Tracer() as tracer:
        BO.bin_fused_matvec_op(idx, data[1][:n])
        torch.cuda.synchronize()
    table = materializes_shape(tracer.trace, (m, b), "f32")
    fused_kernels = sorted(tracer.trace.kernels)
    del idx, op, tracer
    torch.cuda.empty_cache()

    rows = dryrun_results(jobs, futures)
    # a process's log is written last as it ends
    wall = max(Path(log).stat().st_mtime for _, _, log, _ in jobs) - t_sweep
    with open(Path(jobs[0][2]).with_suffix(".json")) as fh:
        dry = json.load(fh)
    say(f"  (a) python -m repro_torch.launch.dryrun, the cells of --mesh "
        f"both --cells all and --cells krr --krr-variant hashjoin, "
        f"{len(jobs) - 1} processes (one a mesh and arch or KRR variant, "
        f"started with (b)'s before the build, {DRYRUN_LANES} at a time): "
        f"{len(rows)} cells traced, every process done {wall:.1f} s after "
        f"the start")
    for r in sorted(rows, key=lambda r: r["name"]):
        say(f"    {r['name']}: trace {r['trace_s']} s, args+temp "
            f"{(r['arg_bytes_per_device'] + r['temp_bytes_per_device']) / 1e9:.2f}"
            f" GB a rank, flops {r['hlo_flops']:.3e}, {r['dominant']}, "
            f"stand-ins {len(r['stand_ins'])}")
    want = sum(cells for *_, cells in jobs)
    if len(rows) != want:
        fail(f"phase 16 (a): {len(rows)} rows of {want} cells")

    # the checks of (b) and (c)
    bad = []
    for name in CALIBRATION:
        d, r = dry[name], real[name]
        same = d["summary"] == r["summary"]
        d_mem = d["arg"] + d["peak"]
        r_mem = r["arg"] + r["growth"]
        say(f"  (b) {name}: counts {'equal' if same else 'DIFFER'}: flops "
            f"{r['summary']['flops']:.6e} (dry {d['summary']['flops']:.6e}), "
            f"hbm bytes {r['summary']['hbm_bytes']:.6e} (dry "
            f"{d['summary']['hbm_bytes']:.6e}), collectives "
            f"{r['summary']['collectives']}, kernels "
            f"{ {k: v['calls'] for k, v in r['summary']['kernels'].items()} },"
            f" host reads {r['summary']['host_reads']}; arguments + peak "
            f"{d_mem / 2**30:.2f} GiB dry against {r_mem / 2**30:.2f} GiB on "
            f"the card (arguments {r['arg'] / 2**30:.2f} GiB + the growth of "
            f"max_memory_allocated {r['growth'] / 2**30:.2f}; dry temporaries "
            f"{(d['peak'] - d['out']) / 2**30:.2f}, outputs "
            f"{d['out'] / 2**30:.2f}); traced run {r['seconds']:.1f} s, dry "
            f"run {d['seconds']:.1f} s")
        if not same:
            bad.append(f"(b) {name}: counts differ: card {r['summary']}, "
                       f"dry {d['summary']}")
        if not abs(r_mem / d_mem - 1) <= DRYRUN_PEAK_BAND:
            bad.append(f"(b) {name}: card {r_mem} B against dry {d_mem} B "
                       f"(band {DRYRUN_PEAK_BAND:.0%})")
    say(f"  (c) the fused matvec op at phase 3's shapes (n {n}, m {m}, B "
        f"{b}) under the tracer on the card: kernels {fused_kernels}, a "
        f"({m}, {b}) float32 tensor made: {table}")
    if table or fused_kernels != ["bin_fused_matvec", "bin_readout"]:
        bad.append(f"(c) the fused matvec made its table ({table}) or ran "
                   f"{fused_kernels}")
    say(f"  phase 16 {time.perf_counter() - t_phase:.1f} s")
    if bad:
        fail("phase 16: " + "; ".join(bad))


def phase_times(torch, data, model, main_counts, errs, dist_state,
                lm_counts, serving, tables, sharded, train_counts, slots,
                mesh, slot_grids, mesh_train, seed):
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
        if key == (m, xq.shape[0], xq.shape[0], 1):
            # phase 6 (c)'s hash-join predictions: the combine of the
            # exchanged values (the readout without a slot)
            from repro_torch.kernels.binning import gather_ref
            qf = featurize_cuda(xq, *lsh, f=T.RECT, table_size=ts)
            ro_timed[key] = combine_times(
                torch, qf[5], gather_ref(qf[4], model.tables).contiguous())
            del qf
            torch.cuda.empty_cache()
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
    slots_counts, slots_shapes = slots
    extra.setdefault("flash_decode", {})["lm_slots_by_shape"] = \
        by_shape_entries(
            slots_shapes.get("flash_decode", {}), decode_serve_times(
                torch, data[0].device, seed,
                slots_shapes.get("flash_decode", {}), label="phase 12"),
            lambda k: "B={} T={} KV={} G={} D={} {}".format(*k))
    mesh_counts, mesh_shapes = mesh
    extra["flash_decode"]["mesh_by_shape"] = by_shape_entries(
        mesh_shapes, decode_serve_times(torch, data[0].device, seed,
                                        mesh_shapes, label="phase 13"),
        lambda k: "B={} T={} KV={} G={} D={} {}".format(*k))
    grid_counts, grid_shapes = slot_grids
    extra["flash_decode"]["slot_grids_by_shape"] = by_shape_entries(
        grid_shapes, decode_serve_times(torch, data[0].device, seed,
                                        grid_shapes, label="phase 14"),
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
    for name, k in sharded["counts"].items():
        if k:
            launches[name] += k
            extra.setdefault(name, {})["sharded_launches"] = k
    extra["route_unpack"]["sharded_device_ms"] = sharded["a"]["b8_buckets"]
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
        entries[-1]["train_launches"] = train_counts[name]
        entries[-1]["lm_slots_launches"] = slots_counts.get(name, 0)
        entries[-1]["mesh_launches"] = mesh_counts.get(name, 0)
        entries[-1]["slot_grids_launches"] = grid_counts.get(name, 0)
        entries[-1]["mesh_train_launches"] = mesh_train.get(name, 0)
        say(f"  {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, library "
            f"{'-' if lib is None else f'{lib:.4f} ms'}; {launches[name]} "
            f"launches")
    return entries


# phase 17: the port's examples (examples/torch_*.py) on the card.  The
# in-process three must launch these (B1, B2, B3, the readout, B5); the
# other two start their launchers in processes of their own.
EXAMPLES_KERNELS = ("featurize", "bin_fused_matvec", "bin_scatter_blocked",
                    "bin_readout", "bin_scatter")
EXAMPLES_TIMEOUT_S = 300.0
# torch_distributed_krr.py's test RMSE on 8 gloo ranks on the CPU
# (``--device cpu``), and how far the card's one NCCL rank may read from
# it: the same data and instances, so only the sums' order differs, and
# both print 1.0697 at the launcher's 4 decimals.  The CG runs a fixed 40
# iterations: its residual must be below pcg_solve's tolerance, 1e-6
# (relative there; here absolute, tighter for labels of std 1).
DISTRIBUTED_KRR_CPU_RMSE = 1.0697
DISTRIBUTED_KRR_RMSE_TOL = 5e-4
DISTRIBUTED_KRR_RESID_TOL = 1e-6
# a shorter schedule than torch_train_lm.py's own (200 steps, a checkpoint
# every 25, failures at steps 60 and 130): at 200 steps the phase took
# 69.4 s on an H100, past its 60 s
TRAIN_LM_ARGS = ("--steps", "60", "--ckpt-every", "10", "--fail-at", "25",
                 "45")


def _example(stem: str):
    """``examples/<stem>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{stem}", REPO / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_in_process(stem: str, argv: list) -> tuple[str, float]:
    """``main(argv)`` of an example in this process: (its output, wall
    s).  Its output is printed indented; a non-zero exit or a failed assert
    fails the run."""
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = _example(stem).main(argv)
    except AssertionError as exc:
        fail(f"{stem}: assertion failed: {exc}")
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.strip().splitlines():
        say(f"    | {line}")
    if rc != 0:
        fail(f"{stem} exited {rc}")
    return out, wall


def example_process(stem: str, argv: list) -> dict:
    """``python examples/<stem>.py argv`` from the repository's root, as a
    user runs it (in the environment the example gives its own launcher:
    this one, ``src`` on the path), in a session
    of its own (``stop_example`` ends it and the launcher it starts), its
    output collected by a thread that notes when it ends."""
    import threading
    run = dict(proc=subprocess.Popen(
        [sys.executable, str(Path("examples") / f"{stem}.py"), *argv],
        cwd=REPO, env=_example(stem).child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True, start_new_session=True), t0=time.perf_counter())

    def collect():
        run["out"] = run["proc"].communicate()[0]
        run["t1"] = time.perf_counter()
    run["reader"] = threading.Thread(target=collect, daemon=True)
    run["reader"].start()
    return run


def stop_example(run: dict) -> None:
    """End an ``example_process`` run's session if it is still going:
    SIGTERM first (``torch.distributed.run`` passes it on to its ranks,
    which run in sessions of their own), SIGKILL after 10 s."""
    import os
    import signal
    for sig in (signal.SIGTERM, signal.SIGKILL):
        if run["proc"].poll() is not None:
            break
        with contextlib.suppress(ProcessLookupError):
            os.killpg(run["proc"].pid, sig)
        with contextlib.suppress(subprocess.TimeoutExpired):
            run["proc"].wait(10)
    run["reader"].join(10)


def example_finished(stem: str, run: dict) -> tuple[str, float]:
    """The output and wall s of ``example_process``'s run; it must exit 0
    within ``EXAMPLES_TIMEOUT_S`` of its start."""
    run["reader"].join(max(0.0, run["t0"] + EXAMPLES_TIMEOUT_S
                           - time.perf_counter()))
    if run["reader"].is_alive():
        stop_example(run)
        fail(f"{stem} still running after {EXAMPLES_TIMEOUT_S:.0f} s")
    out = run["out"]
    for line in out.strip().splitlines()[-8:]:
        say(f"    | {line}")
    if run["proc"].returncode != 0:
        fail(f"{stem} exited {run['proc'].returncode}")
    return out, run["t1"] - run["t0"]


def _number(pattern: str, text: str, what: str) -> tuple:
    import re
    m = re.search(pattern, text)
    if m is None:
        fail(f"{what}: no line matching {pattern!r}")
    return m.groups()


def phase_examples(torch):
    """17. The examples on the card (see the module docstring): the launch
    counts of the in-process three, reset before and read after."""
    card = card_line()
    say(f"== phase 17: the examples on the card ({card})")
    # the two launchers start first: their processes take seconds to reach
    # the card, and run beside the in-process examples
    runs = (example_process("torch_distributed_krr", ["--device", "cuda"]),
            example_process("torch_train_lm",
                            ["--device", "cuda", *TRAIN_LM_ARGS]))
    try:
        counts = examples_in_process(card)
        examples_as_processes(card, *runs)
    finally:
        for run in runs:
            stop_example(run)
    return counts


def examples_in_process(card: str) -> dict:
    """Phase 17's quickstart, gp_smoothness and serve_decode through their
    ``main(argv)``: their numbers checked, the kernels' launches."""
    import tempfile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        say("  torch_quickstart.py --precond nystrom --num-rhs 9 --export")
        out, wall = example_in_process("torch_quickstart", [
            "--device", "cuda", "--precond", "nystrom", "--num-rhs", "9",
            "--export", tmp + "/artifact"])
    exact, = _number(r"exact KRR : rmse=([\d.]+)", out, "quickstart")
    wlsh, iters = _number(r"WLSH KRR  : rmse=([\d.]+).* (\d+) iters", out,
                          "quickstart")
    trip, = _number(r"serving    : (round-trip \S+)", out, "quickstart")
    say(f"  quickstart: {wall:.2f} s; exact RMSE {exact}, WLSH RMSE "
        f"{wlsh} ({iters} PCG iterations), {trip} ({card})")
    say("  torch_gp_smoothness.py")
    out, wall = example_in_process("torch_gp_smoothness",
                                   ["--device", "cuda"])
    rect, rect_ell = _number(
        r"rect .* test RMSE = ([\d.]+)  \(ell\*=(\S+)\)", out,
        "gp_smoothness")
    smooth, smooth_ell = _number(
        r"smooth .* test RMSE = ([\d.]+)  \(ell\*=(\S+)\)", out,
        "gp_smoothness")
    say(f"  gp_smoothness: {wall:.2f} s; rect RMSE {rect} (ell "
        f"{rect_ell}), smooth RMSE {smooth} (ell {smooth_ell}) ({card})")
    if not float(smooth) < float(rect):
        fail(f"gp_smoothness: the smooth bucket's RMSE {smooth} is not "
             f"below rect's {rect}")
    say("  torch_serve_decode.py")
    out, wall = example_in_process("torch_serve_decode",
                                   ["--device", "cuda"])
    err, top = _number(r"max \|batched - direct\| = (\S+) \(max \|pred\| "
                       r"(\S+)\)", out, "serve_decode")
    qps, = _number(r"-> (\d+) QPS", out, "serve_decode")
    say(f"  serve_decode: {wall:.2f} s; {qps} QPS, max |batched - direct| "
        f"{err} of max |pred| {top} ({card})")
    if not float(err) <= 1e-6 * float(top):
        fail(f"serve_decode: batched answers {err} from the direct path")
    counts = launch_counts()
    say(f"  launches of the three: "
        f"{ {k: v for k, v in counts.items() if v} }")
    missing = [k for k in EXAMPLES_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels not launched by the examples: {missing}")
    return counts


def examples_as_processes(card: str, krr: dict, lm: dict) -> None:
    """Phase 17's distributed_krr and train_lm, started by
    ``example_process``: each must exit 0 with its numbers right."""
    say("  torch_distributed_krr.py (one NCCL rank)")
    out, wall = example_finished("torch_distributed_krr", krr)
    ranks, resid, rmse = _number(
        r"on (\d+) rank\(s\).*CG residual (\S+); test RMSE ([\d.]+)", out,
        "distributed_krr")
    say(f"  distributed_krr: {wall:.2f} s; {ranks} rank, CG residual "
        f"{resid} (limit {DISTRIBUTED_KRR_RESID_TOL:g}), test RMSE {rmse} "
        f"against {DISTRIBUTED_KRR_CPU_RMSE} on 8 gloo ranks on the CPU "
        f"(limit {DISTRIBUTED_KRR_RMSE_TOL:g}) ({card})")
    if int(ranks) != 1:
        fail(f"distributed_krr: {ranks} ranks, not one")
    if not float(resid) <= DISTRIBUTED_KRR_RESID_TOL:
        fail(f"distributed_krr: CG residual {resid} not below "
             f"{DISTRIBUTED_KRR_RESID_TOL:g}")
    if not abs(float(rmse) - DISTRIBUTED_KRR_CPU_RMSE) <= \
            DISTRIBUTED_KRR_RMSE_TOL:
        fail(f"distributed_krr: test RMSE {rmse} against "
             f"{DISTRIBUTED_KRR_CPU_RMSE} on the CPU")
    say(f"  torch_train_lm.py {' '.join(TRAIN_LM_ARGS)}".rstrip())
    out, wall = example_finished("torch_train_lm", lm)
    steps, first, last, restarts = _number(
        r"done: (\d+) steps in \S+; loss ([\d.]+) -> ([\d.]+) "
        r"\(restarts=(\d+)", out, "train_lm")
    say(f"  train_lm: {wall:.2f} s; {steps} steps, loss {first} -> {last}, "
        f"{restarts} restarts ({card})")
    if int(restarts) != 2 or not float(last) < float(first):
        fail(f"train_lm: {restarts} restarts, loss {first} -> {last}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibration-dry-run", metavar="JSON",
                    help="phase 16's own subprocess: the dry runs of (b)")
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
    if args.calibration_dry_run:
        calibration_dry_runs(args.calibration_dry_run)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data import make_regression
    MAIN.update(krr_sizes(torch))

    t_start = time.perf_counter()
    walls = {}

    def timed(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[label] = time.perf_counter() - t
        return out

    seed = args.seed
    with dryruns() as sweep:
        timed("1", phase_build, torch)
        t0 = time.perf_counter()
        x, y, xq, _ = make_regression(MAIN["n"], MAIN["n_query"], MAIN["d"],
                                      rough=0.5, seed=seed)
        dev = torch.device("cuda", 0)
        data = tuple(torch.from_numpy(a).to(dev) for a in (x, y, xq))
        del x, y, xq
        say(f"data: n={MAIN['n']} d={MAIN['d']} and {MAIN['n_query']} "
            f"queries from seed {seed} in {time.perf_counter() - t0:.2f} s")
        errs = timed("2", phase_parity, torch, data[0], data[2], seed)
        errs["flash_decode"] = timed("2 (B9)", phase_parity_decode, torch,
                                     dev, seed)
        model, counts, main_phases, main_pred = timed("3", phase_main, torch,
                                                      data, seed)
        timed("4", phase_small, torch, dev, seed)
        dist_state = timed("6", phase_distributed, torch, data, seed,
                           main_pred)
        del main_pred
        lm_counts = timed("7", phase_lm, torch, dev, seed)
        serving = timed("8", phase_serving, torch, data, model, seed)
        tables = timed("9", phase_tables, torch, data, model, seed) + (
            main_phases["layout"],)
        sharded = timed("10", phase_sharded, torch, data, model, serving,
                        seed)
        import torch.distributed as dist
        dist.destroy_process_group()
        train_counts = timed("11", phase_train, torch, dev, seed)
        slots = timed("12", phase_lm_slots, torch, dev, seed)
        mesh = timed("13", phase_mesh, torch, dev, seed)
        slot_grids = timed("14", phase_slot_grids, torch, dev, seed)
        mesh_train = timed("15", phase_train_mesh, torch, dev, seed)
        examples = timed("17", phase_examples, torch)
        entries = timed("5", phase_times, torch, data, model, counts, errs,
                        dist_state, lm_counts, serving, tables, sharded,
                        train_counts, slots, mesh, slot_grids, mesh_train,
                        seed)
        for entry in entries:
            entry["examples_launches"] = examples.get(entry["name"], 0)
        timed("16", phase_dryrun, torch, dev, data, seed, sweep)
    say("phase walls s: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in walls.items()))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
