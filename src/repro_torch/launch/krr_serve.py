"""Online KRR serving driver of the port: load an exported artifact (from
either package), serve a request stream through the micro-batcher, report
latency, QPS and cache stats.

    # an artifact of either package, on the card:
    PYTHONPATH=src python -m repro_torch.launch.krr_serve --artifact DIR \
        --requests 2000 --dup-frac 0.5

    # self-contained smoke (fit -> export -> serve -> verify), on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.krr_serve --selftest \
        --device cpu
    # the lifecycle smoke (canary, swap, rollback, worker restart):
    PYTHONPATH=src python -m repro_torch.launch.krr_serve --selftest \
        --watch --device cpu

    # live observability: Prometheus /metrics + JSON /healthz on a local
    # port; --metrics-dump appends a JSONL snapshot on exit
    PYTHONPATH=src python -m repro_torch.launch.krr_serve --selftest \
        --device cpu --metrics-port 0 --metrics-dump metrics.jsonl

    # SHARDED serving on a (model x data) grid of ranks, one process each
    # (pieces of an export_artifact_sharded grid; rank 0 serves, the other
    # ranks run the worker loop), here 4 gloo ranks on the CPU:
    PYTHONPATH=src torchrun --nproc_per_node 4 -m \
        repro_torch.launch.krr_serve --device cpu --selftest --mesh 2x2

The flags are those of ``repro.launch.krr_serve`` with ``--device`` in place
of ``--backend``.  With ``--mesh`` the process group comes from
``torchrun``'s environment (a group of one without it), NCCL on the card
and gloo on the CPU, and must have model x data ranks.  The request stream
is synthetic by default (uniform points in the training box, with
``--dup-frac`` of requests replaying earlier ones: the traffic the
bucket-exact cache exists for) or read from an (n, d) ``.npy``
(``--input``).  Every request goes through submit -> coalesce -> padded
warm path (a CUDA graph replay on the card; the grid's command under
``--mesh``) or cache hit -> future.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
import time

import numpy as np

from .. import obs
from ..backend import resolve_device
from ..serve import (DeadlineExceeded, LifecycleConfig, MicroBatcher,
                     Overloaded, Predictor, ServingRuntime, ShardedPredictor,
                     WorkerCrashed, bucket_sizes, parse_mesh_shape,
                     version_dir)

# series the live endpoint must expose once the selftest traffic has run —
# the CI serving job scrapes /metrics and fails if any are absent
_REQUIRED_SERIES = (
    "serve_requests_total", "serve_predict_us", "serve_warm_compute_us",
    "serve_padding_bucket_total", "serve_cache_hits_total",
    "serve_cache_misses_total", "serve_cache_entries",
    "serve_models_loaded_total", "serve_batcher_requests_total",
    "serve_batcher_served_total", "serve_queue_wait_us", "serve_batch_size",
    "serve_batch_predict_us", "serve_queue_depth_hwm",
)
# extra series under --mesh (registered per shard at load, so an alerting
# rule can tell "zero overflow" from "not sharded")
_SHARDED_SERIES = ("serve_shard_overflow_dropped", "serve_shard_piece_version")
# extra series under --watch: every lifecycle transition and breaker state
# change must be scrapeable, or the self-healing loop is invisible to ops
_LIFECYCLE_SERIES = (
    "lifecycle_reloads_total", "lifecycle_canary_total",
    "lifecycle_swaps_total", "lifecycle_rollbacks_total",
    "lifecycle_rollback_exhausted_total", "lifecycle_probation_total",
    "lifecycle_nonfinite_predictions_total", "lifecycle_active_version",
    "lifecycle_versions_retained", "lifecycle_worker_crashes_total",
    "lifecycle_worker_restarts_total", "breaker_state",
    "breaker_transitions_total", "breaker_rejections_total",
)


def _verify_metrics(url: str, predictor, *, sharded: bool = False,
                    lifecycle: bool = False) -> str | None:
    """Scrape the live endpoint and check the contract: every required
    series present on /metrics, /healthz green with the predictor component.
    Returns an error string, or None when the endpoint checks out."""
    import json
    import urllib.request

    obs.add_health_provider("predictor", predictor.health)
    try:
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        need = (_REQUIRED_SERIES + (_SHARDED_SERIES if sharded else ())
                + (_LIFECYCLE_SERIES if lifecycle else ()))
        missing = [n for n in need if f"# TYPE {n} " not in text]
        if missing:
            return f"/metrics missing series: {missing}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        if doc.get("status") != "ok":
            return f"/healthz degraded: {doc}"
        if "predictor" not in doc.get("components", {}):
            return "/healthz missing the predictor component"
        return None
    finally:
        obs.remove_health_provider("predictor")


def _synthetic_stream(d: int, n_requests: int, dup_frac: float,
                      seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    fresh = (rng.uniform(0.0, 2.0, size=(n_requests, d))
             .astype(np.float32))
    out = fresh.copy()
    # the first request can never be a replay, so a "fraction" of 1.0 means
    # every row after it
    n_dup = min(int(dup_frac * n_requests), max(n_requests - 1, 0))
    if n_dup:
        # replay earlier rows: repeats arrive interleaved, like real traffic.
        # ascending order matters — processing position i only after every
        # j < i is final keeps each copied row actually present earlier in
        # the stream (unsorted, ~18% of the dups silently went unique)
        dup_pos = rng.choice(n_requests - 1, size=n_dup, replace=False) + 1
        for i in np.sort(dup_pos):
            out[i] = out[rng.integers(0, i)]
    return out


def serve_stream(predictor: Predictor, stream: np.ndarray, *,
                 max_batch: int, max_wait_us: int,
                 target_qps: float = 0.0, max_queue: int = 0,
                 deadline_us: int | None = None,
                 runtime: ServingRuntime | None = None) -> dict:
    """Push every row of ``stream`` through a MicroBatcher; returns the
    batcher stats plus end-to-end wall clock.  ``target_qps`` paces the
    offered load (0 = as fast as the submit loop goes).  Shed (Overloaded)
    and expired (DeadlineExceeded) requests are counted in
    ``stats['rejected']`` — degraded mode answers structurally, it never
    hangs or crashes the driver.  With ``runtime`` the stream runs through
    its SupervisedBatcher against the ACTIVE version instead (worker
    crashes restart, repeated failures trip the breaker; ``CircuitOpen``
    rejections count as shed)."""
    gap = 1.0 / target_qps if target_qps > 0 else 0.0
    kw = dict(max_batch=max_batch, max_wait_us=max_wait_us,
              dim=stream.shape[1], max_queue=max_queue,
              deadline_us=deadline_us)
    with (runtime.make_batcher(**kw) if runtime is not None else
          MicroBatcher(lambda xb: predictor.predict(xb), **kw)) as mb:
        predictor.attach_batcher(mb)
        t0 = time.perf_counter()
        futures = []
        for i, row in enumerate(stream):
            if gap:
                # sleep-based pacing: a busy-wait would pin the GIL and
                # starve the batcher's worker thread
                while True:
                    rem = t0 + i * gap - time.perf_counter()
                    if rem <= 0:
                        break
                    time.sleep(min(rem, 5e-4))
            futures.append(mb.submit(row))
        rows, rejected, crashed = [], 0, 0
        for f in futures:
            try:
                rows.append(f.result(timeout=60.0))
            except (Overloaded, DeadlineExceeded):
                rejected += 1
            except WorkerCrashed:
                crashed += 1    # supervised mode: the batch died, not the run
        wall = time.perf_counter() - t0
        stats = mb.stats()
    stats["wall_s"] = wall
    stats["offered_qps"] = target_qps or float("inf")
    stats["results"] = (np.stack(rows) if rows
                        else np.zeros((0,), np.float32))
    stats["rejected"] = rejected
    stats["crashed_requests"] = crashed
    return stats


def _fit(*, n: int = 1024, d: int = 8, m: int = 128, seed: int = 0,
         device=None):
    """Small in-process fit for --selftest and runs without --artifact
    (numpy-seeded data and instances).  Returns (model, x_train)."""
    from ..core import (RECT, GammaPDF, WLSHKernelSpec, sample_lsh_params,
                        wlsh_krr_fit)

    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32) * np.float32(2.0)
    y = rng.standard_normal(n, dtype=np.float32)
    lsh = sample_lsh_params(rng, m, d, GammaPDF(2.0, 1.0),
                            device=resolve_device(device))
    spec = WLSHKernelSpec(bucket=RECT, pdf=GammaPDF(2.0, 1.0))
    model = wlsh_krr_fit(lsh, x, y, spec, lam=0.5, device=device)
    return model, x


def _export(directory: str, model, *, artifact_id: str = "selftest",
            mesh_shape: tuple[int, int] | None = None) -> None:
    """Publish ``model`` flat or (``mesh_shape``) as a sharded piece grid."""
    from ..serve import export_artifact, export_artifact_sharded

    if mesh_shape is None:
        export_artifact(directory, model, artifact_id=artifact_id)
    else:
        export_artifact_sharded(directory, model, mesh_shape=mesh_shape,
                                artifact_id=artifact_id)


def _fit_and_export(directory: str, *, device=None,
                    mesh_shape: tuple[int, int] | None = None, **fit_kw):
    """``_fit`` + ``_export`` in one call.  Returns (model, x_train)."""
    model, x = _fit(device=device, **fit_kw)
    _export(directory, model, mesh_shape=mesh_shape)
    return model, x


def _agrees(got: np.ndarray, want: np.ndarray, device) -> bool:
    """Served against library predictions: bitwise on the card (rows are
    independent there, whatever the padding); within 1e-6 on the CPU,
    whose plain readout's mean over the instances is not pinned across
    padding shapes."""
    if resolve_device(device).type == "cuda":
        return np.array_equal(got, want)
    return np.allclose(got, want, rtol=0.0, atol=1e-6)


def selftest(metrics_url: str | None = None, device=None) -> int:
    """Export a small artifact, serve 100 requests through the in-process
    batcher, and verify every response against the library predict path
    (bitwise on the card).  With ``metrics_url`` (set by --metrics-port)
    also scrape the live endpoint and fail if a required series is
    missing."""
    from ..core import wlsh_krr_predict

    with tempfile.TemporaryDirectory() as tmp:
        model, xtr = _fit_and_export(tmp + "/artifact", device=device)
        predictor = Predictor(device=device, cache_entries=4096)
        predictor.load(tmp + "/artifact")
        n_graphs = predictor.warmup(sizes=bucket_sizes(16))
        stream = _synthetic_stream(xtr.shape[1], 100, dup_frac=0.3, seed=1)
        stats = serve_stream(predictor, stream, max_batch=16,
                             max_wait_us=1000)
        expect = wlsh_krr_predict(model, stream).cpu().numpy()
        if stats["served"] != 100:
            print(f"[krr_serve] SELFTEST FAIL: served {stats['served']}/100")
            return 1
        if not _agrees(stats["results"], expect, device):
            print("[krr_serve] SELFTEST FAIL: batched serving != library "
                  "predictions")
            return 1
        # replaying the stream must reproduce the first pass bit for bit
        # (cache hits replay the stored rows; warm rows rerun one function)
        replay = serve_stream(predictor, stream, max_batch=16,
                              max_wait_us=1000)
        if not np.array_equal(replay["results"], stats["results"]):
            print("[krr_serve] SELFTEST FAIL: replayed stream not bitwise "
                  "reproducible")
            return 1
        if predictor.compile_count() != n_graphs:
            print(f"[krr_serve] SELFTEST FAIL: graphs {n_graphs} -> "
                  f"{predictor.compile_count()} under traffic")
            return 1
        if metrics_url is not None:
            err = _verify_metrics(metrics_url, predictor)
            if err is not None:
                print(f"[krr_serve] SELFTEST FAIL: {err}")
                return 1
        cache = predictor.cache_stats()
        print(f"[krr_serve] selftest ok on {predictor.device}: 100/100 "
              f"round-tripped ("
              + ("bitwise" if predictor.device.type == "cuda" else "<=1e-6")
              + f" of the library path, replay bitwise, {n_graphs} graphs); "
              f"{stats['batches']} batches (mean {stats['mean_batch']:.1f} "
              f"rows), p50 {stats['p50_us']:.0f}us p99 {stats['p99_us']:.0f}us, "
              f"cache hit rate {cache['hit_rate']:.2f}"
              + ("; metrics endpoint verified" if metrics_url else ""))
    return 0


def selftest_sharded(mesh_shape: tuple[int, int],
                     metrics_url: str | None = None, device=None) -> int:
    """Sharded-serving smoke, on rank 0 of a grid whose other ranks run
    the worker loop: fit, export the piece grid, host it behind the
    batcher, serve 100 queries and verify them against the single-host
    ``Predictor`` on the same model (bitwise on one model rank, else within
    1e-5), a bitwise stream replay, and no routing overflow."""
    with tempfile.TemporaryDirectory() as tmp, ShardedPredictor(
            mesh_shape=mesh_shape, device=device,
            cache_entries=4096) as predictor:
        model, xtr = _fit_and_export(tmp + "/sharded", device=device,
                                     mesh_shape=mesh_shape)
        _export(tmp + "/single", model)
        single = Predictor(device=device, cache_entries=4096)
        single.load(tmp + "/single")
        predictor.load(tmp + "/sharded")
        n_buckets = predictor.warmup(sizes=bucket_sizes(16))
        stream = _synthetic_stream(xtr.shape[1], 100, dup_frac=0.3, seed=1)
        stats = serve_stream(predictor, stream, max_batch=16,
                             max_wait_us=1000)
        if stats["served"] != 100:
            print(f"[krr_serve] SELFTEST FAIL: served {stats['served']}/100")
            return 1
        expect = single.predict(stream, use_cache=False)
        err = float(np.abs(stats["results"] - expect).max())
        one_model_rank = mesh_shape[0] == 1
        if (not np.array_equal(stats["results"], expect) if one_model_rank
                else not err <= 1e-5 * float(np.abs(expect).max())):
            print(f"[krr_serve] SELFTEST FAIL: sharded serving off the "
                  f"single-host path by {err:.2e} ("
                  + ("not bitwise on one model rank" if one_model_rank
                     else "> 1e-5 of max|pred|") + ")")
            return 1
        replay = serve_stream(predictor, stream, max_batch=16,
                              max_wait_us=1000)
        if not np.array_equal(replay["results"], stats["results"]):
            print("[krr_serve] SELFTEST FAIL: replayed stream not bitwise "
                  "reproducible")
            return 1
        overflow = predictor.health()["shards"]["selftest"]["overflow"]
        if any(overflow):
            print(f"[krr_serve] SELFTEST FAIL: routing overflow dropped "
                  f"buckets: {overflow}")
            return 1
        if metrics_url is not None:
            merr = _verify_metrics(metrics_url, predictor, sharded=True)
            if merr is not None:
                print(f"[krr_serve] SELFTEST FAIL: {merr}")
                return 1
        cache = predictor.cache_stats()
        print(f"[krr_serve] sharded selftest ok (mesh {mesh_shape[0]}x"
              f"{mesh_shape[1]} on {predictor.device}): 100/100 "
              + ("bitwise equal to" if one_model_rank else
                 f"within {err:.1e} of")
              + f" the single-host Predictor (replay bitwise, overflow 0); "
              f"{n_buckets} buckets warmed, {stats['batches']} batches, "
              f"p50 {stats['p50_us']:.0f}us p99 {stats['p99_us']:.0f}us, "
              f"cache hit rate {cache['hit_rate']:.2f}")
    return 0


def selftest_lifecycle(metrics_url: str | None = None, device=None,
                       mesh_shape: tuple[int, int] | None = None) -> int:
    """Self-healing smoke (--selftest --watch) against a real version root:
    v1 serves a stream clean; a POISONED v2 (tables corrupted on disk after
    export) is canary-rejected with zero failed requests on v1; a good v3
    swaps in mid-stream with no dropped request and no new graph on the
    warm buckets; a forced post-swap health regression auto-rolls back to
    v1 (with ``mesh_shape``, on rank 0 of the grid: sharded versions and an
    operator rollback, the sharded predictor having no fault plan); and a
    crashed batcher worker recovers through the breaker's half-open probe.
    With ``metrics_url`` the lifecycle_*/breaker_* series are asserted on
    the live endpoint."""
    cfg = LifecycleConfig(probation_s=30.0, probation_min_requests=20,
                          probation_max_error_rate=0.1, retain=2,
                          load_retries=2, warm_sizes=bucket_sizes(16))
    rt = ServingRuntime(tempfile.mkdtemp(prefix="krr_serve_"),
                        device=device, mesh_shape=mesh_shape,
                        cache_entries=4096, config=cfg)
    try:
        return _lifecycle_checks(rt, cfg, device, mesh_shape, metrics_url)
    finally:
        import shutil
        if rt.sharded:
            rt.predictor.stop()
        shutil.rmtree(rt.root, ignore_errors=True)


def _lifecycle_checks(rt, cfg, device, mesh_shape, metrics_url) -> int:
    import threading

    from ..errors import CircuitOpen, FaultInjected
    from ..testing.faults import (FaultPlan, crash_supervised_workers,
                                  poison_artifact_tables)

    root = rt.root
    model, xtr = _fit(device=device)
    d = xtr.shape[1]
    _export(version_dir(root, 1), model, mesh_shape=mesh_shape)
    r = rt.poll_once()
    if r["action"] != "swap" or rt.active_version != 1:
        print(f"[krr_serve] SELFTEST FAIL: v1 not adopted: {r}")
        return 1
    stream = _synthetic_stream(d, 100, dup_frac=0.3, seed=1)
    stats = serve_stream(rt.predictor, stream, max_batch=16,
                         max_wait_us=1000, runtime=rt)
    if stats["served"] != 100 or stats["rejected"] \
            or stats["crashed_requests"]:
        print(f"[krr_serve] SELFTEST FAIL: v1 stream "
              f"{stats['served']}/100 served, "
              f"{stats['rejected']} rejected")
        return 1
    base = stats["results"]
    c0 = rt.compile_count()

    # poisoned v2: published complete, then corrupted on disk (the
    # damage only the canary catches: validation passes)
    _export(version_dir(root, 2), model, mesh_shape=mesh_shape)
    poison_artifact_tables(version_dir(root, 2), scale=3.0)
    r = rt.poll_once()
    if r["action"] != "canary_reject" or rt.active_version != 1:
        print(f"[krr_serve] SELFTEST FAIL: poisoned v2 not rejected: "
              f"{r}")
        return 1
    stats = serve_stream(rt.predictor, stream, max_batch=16,
                         max_wait_us=1000, runtime=rt)
    if stats["served"] != 100 or stats["rejected"] \
            or stats["crashed_requests"] \
            or not np.array_equal(stats["results"], base):
        print("[krr_serve] SELFTEST FAIL: v1 service disturbed by the "
              "rejected candidate")
        return 1

    # good v3: swap mid-stream, no downtime, no new graph
    _export(version_dir(root, 3), model, mesh_shape=mesh_shape)
    swap_report = {}

    def mid_stream_poll():
        time.sleep(0.01)
        swap_report.update(rt.poll_once())

    poller = threading.Thread(target=mid_stream_poll)
    poller.start()
    stats = serve_stream(rt.predictor, stream, max_batch=16,
                         max_wait_us=1000, target_qps=2000.0, runtime=rt)
    poller.join()
    if swap_report.get("action") != "swap" or rt.active_version != 3:
        print(f"[krr_serve] SELFTEST FAIL: v3 not swapped mid-stream: "
              f"{swap_report}")
        return 1
    if stats["served"] != 100 or stats["rejected"] \
            or stats["crashed_requests"]:
        print(f"[krr_serve] SELFTEST FAIL: swap dropped requests "
              f"({stats['served']}/100)")
        return 1
    if not _agrees(stats["results"], base, device):
        print("[krr_serve] SELFTEST FAIL: post-swap results diverged")
        return 1
    c1 = rt.compile_count()
    if c1 != c0:
        print(f"[krr_serve] SELFTEST FAIL: graphs on the warm buckets "
              f"{c0} -> {c1} across the swap")
        return 1

    # forced health regression inside the probation window -> rollback
    if mesh_shape is None:
        rt.predictor.fault_plan = FaultPlan(serve_fail_every=1)
        probe = stream[:1]
        for _ in range(cfg.probation_min_requests * 3):
            try:
                rt.predict(probe, use_cache=False)
            except FaultInjected:
                pass
            if rt.active_version == 1:
                break
        rt.predictor.fault_plan = None
        rolled = "auto"
    else:
        rt.rollback("forced regression (selftest)")
        rolled = "operator"
    if rt.active_version != 1:
        print(f"[krr_serve] SELFTEST FAIL: no rollback to v1 "
              f"(active v{rt.active_version})")
        return 1
    out = rt.predict(np.asarray(stream[:4]), use_cache=False)
    if not _agrees(out, base[:4], device):
        print("[krr_serve] SELFTEST FAIL: rolled-back v1 not serving")
        return 1

    # worker crash -> breaker opens -> half-open probe recovers
    sup = rt.make_batcher(failure_threshold=1, cooldown_s=0.2,
                          restart_backoff_s=0.01, max_batch=8,
                          max_wait_us=500, dim=d)
    try:
        sup.predict(stream[0], timeout=30.0)
        crash_supervised_workers(sup, crashes=1)
        try:
            sup.predict(stream[0], timeout=30.0)
            print("[krr_serve] SELFTEST FAIL: crashed worker answered")
            return 1
        except WorkerCrashed:
            pass
        try:
            sup.predict(stream[0], timeout=30.0)
            print("[krr_serve] SELFTEST FAIL: open breaker admitted")
            return 1
        except CircuitOpen:
            pass
        time.sleep(0.25)    # past the cooldown: half-open probe window
        sup.predict(stream[0], timeout=30.0)
        st = sup.stats()
        if st["breaker"]["state"] != "closed" or st["restarts"] != 1:
            print(f"[krr_serve] SELFTEST FAIL: breaker not recovered: "
                  f"{st['breaker']}, restarts {st['restarts']}")
            return 1
    finally:
        sup.close()
    if metrics_url is not None:
        err = _verify_metrics(metrics_url, rt,
                              sharded=mesh_shape is not None,
                              lifecycle=True)
        if err is not None:
            print(f"[krr_serve] SELFTEST FAIL: {err}")
            return 1
    h = rt.health()
    print(f"[krr_serve] lifecycle selftest ok on {rt.predictor.device}"
          + (f" (mesh {mesh_shape[0]}x{mesh_shape[1]})"
             if mesh_shape else "")
          + f": poisoned v2 canary-rejected with zero failed requests, "
          f"v3 swapped live (graphs {c0}->{c1}), {rolled} rollback to "
          f"v1, breaker reopened after worker crash; rejected versions "
          f"{h['rejected_versions']}"
          + ("; metrics endpoint verified" if metrics_url else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", default=None,
                    help="artifact directory (from either package's "
                         "export_artifact); omitted -> fit and export a "
                         "small model in-process")
    ap.add_argument("--selftest", action="store_true",
                    help="fit -> export -> serve 100 requests -> verify "
                         "(smoke); ignores the traffic flags")
    ap.add_argument("--watch", action="store_true",
                    help="treat --artifact as a VERSION ROOT (v1/, v2/, "
                         "...) and self-heal: poll for new versions, "
                         "canary-validate, swap atomically, auto-rollback "
                         "on post-swap regression, restart crashed batcher "
                         "workers behind a circuit breaker (with "
                         "--selftest: run the lifecycle smoke)")
    ap.add_argument("--watch-interval", type=float, default=0.5,
                    metavar="S", help="version-poll cadence under --watch")
    ap.add_argument("--no-canary", action="store_true",
                    help="skip golden-query validation before a swap "
                         "(--watch; accepts any loadable version)")
    ap.add_argument("--rollback-window", type=float, default=5.0,
                    metavar="S",
                    help="probation: watch post-swap health for S seconds "
                         "and auto-rollback on regression (0 disables)")
    ap.add_argument("--retain", type=int, default=2,
                    help="previous versions kept hosted as rollback "
                         "targets under --watch")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the model lives and the warm path runs "
                         "(default: the card; cpu runs the plain path)")
    ap.add_argument("--input", default=None,
                    help=".npy of (n, d) request points (default: synthetic)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--dup-frac", type=float, default=0.5,
                    help="fraction of synthetic requests replaying earlier "
                         "ones (the bucket-exact cache's traffic)")
    ap.add_argument("--target-qps", type=float, default=0.0,
                    help="paced offered load; 0 = unthrottled")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-us", type=int, default=2000)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="load shedding: submits past this queue depth fail "
                         "fast with Overloaded (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline budget; a request still "
                         "queued past it fails with DeadlineExceeded "
                         "(0 = no deadline)")
    ap.add_argument("--cache-entries", type=int, default=65536,
                    help="bucket-exact cache size; 0 disables")
    ap.add_argument("--mesh", default=None, metavar="MxN",
                    help="serve SHARDED on a (model_shards M x data_shards "
                         "N) grid of ranks, e.g. --mesh 2x2 under torchrun "
                         "with 4 processes; the artifact must be a "
                         "matching export_artifact_sharded piece grid "
                         "(omitted -> single-host Predictor)")
    ap.add_argument("--placement", default=None, metavar="LO:HI",
                    help="host the model on model-axis rows [LO, HI) of the "
                         "--mesh so several models co-serve (default: the "
                         "whole model axis)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="expose /metrics (Prometheus text) + /healthz on "
                         "127.0.0.1:PORT for the lifetime of the run "
                         "(0 = OS-picked port, printed at startup)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="append a JSONL metrics snapshot to PATH on exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    mesh_shape = parse_mesh_shape(args.mesh) if args.mesh else None
    if mesh_shape is not None:
        return _grid_main(args, mesh_shape)
    return _front_main(args, None)


def _grid_main(args, mesh_shape) -> int:
    """--mesh: join the process group (torchrun's, or a group of one), run
    the front end on rank 0 and the worker loop on every other rank, and
    leave a group this run created."""
    import torch.distributed as dist

    from .mesh import init_distributed

    owns = not dist.is_initialized()
    if owns:
        init_distributed(args.device)
    try:
        if dist.get_rank() == 0:
            return _front_main(args, mesh_shape)
        # the same ShardedPredictor rank 0 builds, collectively; then the
        # worker loop until rank 0 stops the grid
        ShardedPredictor(mesh_shape=mesh_shape,
                         device=args.device).serve_forever()
        return 0
    finally:
        if owns:
            dist.destroy_process_group()


def _front_main(args, mesh_shape) -> int:
    server = None
    if args.metrics_port is not None:
        server = obs.serve_metrics(args.metrics_port)
        print(f"[krr_serve] metrics: {server.url}/metrics  "
              f"health: {server.url}/healthz")
    try:
        rc = _dispatch(args, mesh_shape, server)
    finally:
        if args.metrics_dump:
            obs.REGISTRY.write_jsonl(args.metrics_dump,
                                     extra={"driver": "krr_serve"})
            print(f"[krr_serve] metrics snapshot -> {args.metrics_dump}")
        if server is not None:
            server.close()
    return rc


def _dispatch(args, mesh_shape, server) -> int:
    if args.selftest:
        url = server.url if server is not None else None
        if args.watch:
            return selftest_lifecycle(metrics_url=url, device=args.device,
                                      mesh_shape=mesh_shape)
        if mesh_shape is not None:
            return selftest_sharded(mesh_shape, metrics_url=url,
                                    device=args.device)
        return selftest(metrics_url=url, device=args.device)
    if args.watch:
        return _watch_main(args, mesh_shape, server)
    placement = None
    if args.placement:
        lo, hi = args.placement.split(":")
        placement = (int(lo), int(hi))
    with contextlib.ExitStack() as stack:
        if mesh_shape is not None:
            predictor = stack.enter_context(ShardedPredictor(
                mesh_shape=mesh_shape, device=args.device,
                cache_entries=args.cache_entries))
            load = lambda path: predictor.load(path, placement=placement)
        else:
            predictor = Predictor(device=args.device,
                                  cache_entries=args.cache_entries)
            load = predictor.load
        if server is not None:
            obs.add_health_provider("predictor", predictor.health)
        if args.artifact:
            aid = load(args.artifact)
        else:
            # the demo artifact lives only for this run
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="krr_serve_"))
            print(f"[krr_serve] no --artifact: fitting a demo model "
                  f"-> {tmp}/artifact")
            span = ((placement[1] - placement[0], mesh_shape[1])
                    if mesh_shape and placement else mesh_shape)
            _fit_and_export(tmp + "/artifact", device=args.device,
                            mesh_shape=span)
            aid = load(tmp + "/artifact")
        return _serve_main(predictor, aid, args)


def _stream(args, d: int):
    """The request stream: --input's rows, or synthetic; None (after a
    message) when --input has the wrong shape."""
    if not args.input:
        return _synthetic_stream(d, args.requests, args.dup_frac, args.seed)
    stream = np.load(args.input).astype(np.float32)
    if stream.ndim != 2 or stream.shape[1] != d:
        print(f"[krr_serve] --input must be (n, {d}), got {stream.shape}",
              file=sys.stderr)
        return None
    return stream


def _deadline_us(args):
    return int(args.deadline_ms * 1000) if args.deadline_ms > 0 else None


def _model_dim(predictor, aid=None) -> int:
    hosted = predictor._hosted(aid)
    return (hosted.d if isinstance(predictor, ShardedPredictor)
            else hosted.loaded.model.lsh.d)


def _watch_main(args, mesh_shape, server) -> int:
    """--watch without --selftest: host a version root with the watcher
    running (reload/canary/rollback on a daemon thread), serve the stream
    through the supervised batcher, report lifecycle health.  Publish a new
    ``v<N>`` under the root while this runs and it swaps in live."""
    cfg = LifecycleConfig(poll_interval_s=args.watch_interval,
                          canary_enabled=not args.no_canary,
                          probation_s=args.rollback_window,
                          retain=args.retain, load_retries=2,
                          warm_sizes=bucket_sizes(args.max_batch))
    with contextlib.ExitStack() as stack:
        root = args.artifact
        if root is None:
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="krr_serve_"))
            root = tmp + "/versions"
            print(f"[krr_serve] no --artifact: fitting a demo model "
                  f"-> {version_dir(root, 1)}")
            model, _ = _fit(device=args.device)
            _export(version_dir(root, 1), model, mesh_shape=mesh_shape)
        rt = ServingRuntime(root, device=args.device, mesh_shape=mesh_shape,
                            cache_entries=args.cache_entries, config=cfg)
        if rt.sharded:
            stack.callback(rt.predictor.stop)
        if server is not None:
            obs.add_health_provider("lifecycle", rt.health)
            stack.callback(obs.remove_health_provider, "lifecycle")
        rt.poll_once()
        if rt.active_version is None:
            print(f"[krr_serve] no published version under {root} "
                  f"(expected {version_dir(root, 1)} etc.)",
                  file=sys.stderr)
            return 2
        rt.start()
        stack.callback(rt.stop)
        d = _model_dim(rt.predictor, f"v{rt.active_version}")
        print(f"[krr_serve] watching {root}: serving v{rt.active_version} "
              f"on {rt.predictor.device} (poll every "
              f"{cfg.poll_interval_s}s, canary "
              f"{'on' if cfg.canary_enabled else 'OFF'}, rollback window "
              f"{cfg.probation_s}s, retain {cfg.retain})")
        stream = _stream(args, d)
        if stream is None:
            return 2
        stats = serve_stream(rt.predictor, stream, max_batch=args.max_batch,
                             max_wait_us=args.max_wait_us,
                             target_qps=args.target_qps,
                             max_queue=args.max_queue,
                             deadline_us=_deadline_us(args), runtime=rt)
        h = rt.health()
        print(f"[krr_serve] {stats['served']} requests in "
              f"{stats['wall_s']:.2f}s -> {stats['qps']:.0f} QPS "
              f"(p50 {stats['p50_us']:.0f}us p99 {stats['p99_us']:.0f}us, "
              f"{stats['crashes']} worker crashes / {stats['restarts']} "
              f"restarts, breaker {stats['breaker']['state']})")
        print(f"[krr_serve] lifecycle: active v{h['active_version']}, "
              f"retained {h['retained_versions']}, rejected "
              f"{h['rejected_versions']}, ok={h['ok']}")
        return 0


def _serve_main(predictor, aid: str, args) -> int:
    d = _model_dim(predictor, aid)
    n_graphs = predictor.warmup(artifact_id=aid,
                                sizes=bucket_sizes(args.max_batch))
    hosted = predictor._hosted(aid)
    sharded = isinstance(predictor, ShardedPredictor)
    meta = hosted.manifest if sharded else hosted.loaded.meta
    print(f"[krr_serve] hosting {aid!r} (d={d}, exported by "
          f"{meta.get('framework', 'jax')}, backend {meta.get('backend')}) "
          f"on {predictor.device}"
          + (f", grid {predictor.mesh_shape[0]}x{predictor.mesh_shape[1]}"
             f" placement {list(hosted.placement)}; {n_graphs} padding "
             f"buckets run" if sharded else
             f"; {n_graphs} padding-bucket graphs"))
    stream = _stream(args, d)
    if stream is None:
        return 2
    stats = serve_stream(predictor, stream, max_batch=args.max_batch,
                         max_wait_us=args.max_wait_us,
                         target_qps=args.target_qps,
                         max_queue=args.max_queue,
                         deadline_us=_deadline_us(args))
    print(f"[krr_serve] {stats['served']} requests in {stats['wall_s']:.2f}s "
          f"-> {stats['qps']:.0f} QPS achieved "
          f"({stats['batches']} batches, mean {stats['mean_batch']:.1f} "
          f"rows/batch)")
    print(f"[krr_serve] latency p50 {stats['p50_us']:.0f}us  "
          f"p99 {stats['p99_us']:.0f}us  (max_batch={args.max_batch}, "
          f"max_wait={args.max_wait_us}us)")
    if stats["rejected"]:
        print(f"[krr_serve] degraded mode: {stats['shed']} shed, "
              f"{stats['deadline_expired']} deadline-expired "
              f"({stats['rejected']} rejected total, shed rate "
              f"{stats['shed_rate']:.2f})")
    cache = predictor.cache_stats(artifact_id=aid)
    if cache is not None:
        print(f"[krr_serve] cache: {cache['entries']} entries, "
              f"hit rate {cache['hit_rate']:.2f} "
              f"({cache['hits']} hits / {cache['misses']} misses)")
    health = predictor.health()
    print(f"[krr_serve] health: ok={health['ok']} "
          f"requests={health['requests']} errors={health['errors']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
