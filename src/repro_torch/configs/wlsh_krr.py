"""The paper's own workload: distributed WLSH-KRR, a copy of the JAX
package's ``configs/wlsh_krr.py`` (which imports no JAX), kept here so the
port imports nothing of the JAX package; ``tests/test_torch_wlsh_krr_config.py``
holds the two equal.

Sized like the paper's largest experiment scaled to a 256-chip pod:
Forest-Cover-scale n with m instances, CountSketch table mode (the only mode
whose bucket merge is a psum — see DESIGN.md §3).  ``chip_smoke.py`` reads
its sizes from ``CONFIG`` (phases 3 and 6).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class WLSHKRRConfig:
    name: str = "wlsh_krr"
    family: str = "krr"
    n_points: int = 4_194_304     # 2^22 training points (Forest Cover x ~7)
    dim: int = 64                 # feature dimension
    m: int = 64                   # independent WLSH instances
    table_size: int = 1 << 23     # CountSketch table (2 x n)
    bucket: str = "rect"
    pdf_shape: float = 2.0        # p(w) = w e^{-w}
    lam: float = 1.0
    cg_iters: int = 32            # iterations of the fixed-iteration step
    backend: str = "auto"         # the JAX package's operator backend
                                  # (auto = Pallas on TPU); the port reads
                                  # no backend: a tensor's device decides
    fused: bool = True            # one-pass slot-blocked matvec where legal
                                  # (unsharded data axes); split otherwise
    blocked_split: bool = True    # sharded psum path: visit-list split
                                  # kernels off the same slot-blocked layout
                                  # (tables stay psum-able)
    precond: str = "none"         # PCG preconditioner (core/precond.py):
                                  # none | jacobi (any mesh) | nystrom
                                  # (unsharded data axes only)
    precond_rank: int = 128       # Nyström pivot rank (mirrors
                                  # core.precond.DEFAULT_NYSTROM_RANK)
    num_rhs: int = 1              # RHS block width k: batched KRR targets /
                                  # GP posterior samples per solve
    table_mode: str = "psum"      # bucket-table merge strategy:
                                  # psum (dense (m, B) tables; paper-faithful)
                                  # | hashjoin (table sharded over data,
                                  # all_to_all nonzero routing — DESIGN.md §6)
    cap_factor: float = 2.0       # hashjoin per-destination capacity factor
                                  # (cap ~ cap_factor·e/n_shards; overflow
                                  # buckets are dropped)
    wire_dtype: str = "bf16"      # hashjoin all_to_all payload dtype:
                                  # bf16 (half the bytes, f32 accumulate,
                                  # accuracy pinned by tests) | f32 (exact)
    overflow: str = "warn"        # hashjoin capacity-overflow policy
                                  # (DESIGN.md §9): raise | warn | allow —
                                  # dropped-bucket counts are always
                                  # accounted, never silent
    solve_checkpoint_every: int = 0  # persist PCG SolveState every N
                                  # iterations (0 = off); a preempted fit
                                  # resumes from the last saved chunk
    serve_mesh: str = "8x32"      # sharded SERVING grid "MxN" (model_shards
                                  # x data_shards) for export_artifact_sharded
                                  # / ShardedPredictor; the table piece (i, j)
                                  # holds slots [j·B/N, (j+1)·B/N) of instance
                                  # rows [i·m/M, (i+1)·m/M) — DESIGN.md §10
    serve_max_batch: int = 1024   # serving padding-bucket cap (power of two,
                                  # >= data_shards; requests above it chunk)
    serve_dedup: bool = False     # serving wire mode: False = broadcast
                                  # route (lowest latency, can't overflow);
                                  # True = training routing's deduplicated
                                  # cells (bulk scoring)
    notes: str = "paper's technique; data-sharded PCG step over the mesh"


CONFIG = WLSHKRRConfig()

# Shape cells: (name, n_points, m).
KRR_SHAPES = {
    "krr_4m": dict(n_points=4_194_304, m=64, table_size=1 << 23),
    "krr_32m": dict(n_points=33_554_432, m=32, table_size=1 << 26),
}
