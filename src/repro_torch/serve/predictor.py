"""Warm-path predictor: multi-model hosting with padding buckets, one CUDA
graph per bucket on the card.

A hosted model serves ``featurize_buckets -> predict_from_buckets`` with the
artifact's normalization folded in.  Every batch is padded up to a
power-of-two PADDING BUCKET (1, 2, 4, ... max_batch); batches above
``max_batch`` are served in max_batch-sized chunks.  Rows are independent
(featurize works on each point alone, the readout adds each point's
instances in a fixed order), so padding changes no served row.

On the card, each (model, bucket) is captured once as a ``torch.cuda.
CUDAGraph`` over static buffers: normalization, B1 (featurize), the readout
(B4 with its combine: four launches at m = 64), denormalization.  The first
call at a bucket runs the function once eagerly on the model's stream, then
captures it (``capture_error_mode="thread_local"``, so another thread's
CUDA call cannot break the capture), all buckets of a model in one memory
pool, largest first.  The warm path then copies the padded request into a
pinned host buffer, copies it to the static input on the model's stream,
replays the graph, copies the output back and synchronizes the stream, all
under the model's lock (a graph's buffers are shared state).  A failed
capture raises: a CUDA tensor is never served eagerly.  ``compile_count``
is the number of graphs captured.  A graph's kernel launches are recorded
at capture and counted in the kernels' launch counters at each replay
(``kernels.captured_launches``); ``graph_stats`` gives each graph's
launches a replay and its replays.

On the CPU the same function runs eagerly (the plain path) and
``compile_count`` is 0.

The bucket-exact cache (serve/cache.py) fronts the warm path: rows whose
bucket key is cached skip the model; the rest run the warm path and their
results are inserted.  Hits replay the warm path's own rows.
"""
from __future__ import annotations

import threading
from time import perf_counter

import numpy as np
import torch

from .. import obs
from ..backend import resolve_device
from ..core.bucket_fns import get_bucket_fn
from ..errors import InvalidRequest
from ..kernels import captured_launches, credit_launches, record_tally
from ..testing.faults import FaultPlan, serve_fault
from .artifact import LoadedArtifact, load_artifact
from .cache import BucketKeyFn, PredictionCache

DEFAULT_MAX_BATCH = 1024


def padding_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch (callers chunk above
    the cap)."""
    if n <= 0:
        raise ValueError(f"need a positive batch, got {n}")
    return min(1 << (n - 1).bit_length(), max_batch)


def bucket_sizes(limit: int) -> tuple[int, ...]:
    """Every padding bucket up to ``limit``: (1, 2, 4, ..., >= limit).  Feed
    to ``Predictor.warmup`` so a batcher bounded by ``limit`` never captures
    mid-traffic."""
    if limit <= 0:
        raise ValueError(f"need a positive limit, got {limit}")
    return tuple(1 << p for p in range((limit - 1).bit_length() + 1))


def _model_fn(loaded: LoadedArtifact):
    """(b, d) f32 tensor on the model's device -> predictions (b[, k])."""
    op, norm = loaded.operator, loaded.norm
    tables = loaded.model.tables
    if norm is None:
        return lambda x: op.predict_from_buckets(op.featurize_buckets(x),
                                                 tables)
    dev = tables.device

    def f32(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(dev)

    x_mean, x_std = f32(norm.x_mean), f32(norm.x_std)
    y_mean, y_std = f32(norm.y_mean), f32(norm.y_std)

    def fn(x):
        out = op.predict_from_buckets(op.featurize_buckets(
            (x - x_mean) / x_std), tables)
        return out * y_std + y_mean

    return fn


class BucketGraph:
    """One captured padding bucket: the graph, its static device buffers,
    their pinned host twins, the kernel launches recorded at capture (a
    ``captured_launches`` record, credited to the counters at each replay)
    and the replays."""

    def __init__(self, graph, x_static, out_static, launches):
        self.graph = graph
        self.x_static = x_static
        self.out_static = out_static
        self.x_host = torch.zeros(x_static.shape, dtype=torch.float32,
                                  pin_memory=True)
        self.out_host = torch.empty(out_static.shape, dtype=out_static.dtype,
                                    pin_memory=True)
        self.launches = launches
        self.replays = 0

    def run(self, x: np.ndarray, stream) -> np.ndarray:
        """Serve ``x`` (b <= bucket rows): pinned copy in, replay, copy out,
        synchronize.  The caller holds the model's lock."""
        b = x.shape[0]
        xh = self.x_host.numpy()
        xh[:b] = x
        xh[b:] = 0.0
        with torch.cuda.stream(stream):
            self.x_static.copy_(self.x_host, non_blocking=True)
            self.graph.replay()
            self.out_host.copy_(self.out_static, non_blocking=True)
        stream.synchronize()
        self.replays += 1
        credit_launches(self.launches)
        return self.out_host.numpy()[:b].copy()


class _HostedModel:
    def __init__(self, loaded: LoadedArtifact, cache_entries: int):
        self.loaded = loaded
        self.fn = _model_fn(loaded)
        self.keyfn = BucketKeyFn(loaded.model.lsh,
                                 get_bucket_fn(loaded.model.bucket_name))
        self.cache = (PredictionCache(cache_entries) if cache_entries > 0
                      else None)
        # raw query bytes -> bucket key: skips the numpy hash for repeats
        self.keymemo = (PredictionCache(cache_entries) if cache_entries > 0
                        else None)
        self.on_card = loaded.model.tables.device.type == "cuda"
        self.lock = threading.Lock()       # the graphs' buffers
        self.graphs: dict[int, BucketGraph] = {}
        self.stream = torch.cuda.Stream(loaded.model.tables.device) \
            if self.on_card else None
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None


class Predictor:
    """Hosts fitted models keyed by artifact id and serves point predictions.

    ``predict`` takes a (b, d) batch (or one (d,) point) and returns numpy
    predictions: (b,) for a single-target model, (b, k) for a multi-RHS fit.
    ``cache_entries > 0`` enables the bucket-exact cache per model.
    ``device`` (None: the card, raising without one) is where the models'
    arrays live and the warm path runs.
    """

    def __init__(self, *, device=None, max_batch: int = DEFAULT_MAX_BATCH,
                 cache_entries: int = 0,
                 fault_plan: FaultPlan | None = None):
        if max_batch & (max_batch - 1) or max_batch <= 0:
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.cache_entries = int(cache_entries)
        self.fault_plan = fault_plan    # chaos tests: warm-path stall/fail
        self._models: dict[str, _HostedModel] = {}
        self._default_id: str | None = None
        self._lock = threading.Lock()
        self._n_predicts = 0            # warm-path calls (drives serve_fault)
        self._n_requests = 0
        self._n_errors = 0
        self._last_error: str | None = None
        self._batcher = None            # attached MicroBatcher, for health()
        self._m_requests = obs.counter(
            "serve_requests_total", "predict() calls accepted").labels()
        self._m_errors = obs.counter(
            "serve_errors_total", "predict() calls that raised").labels()
        self._m_predict_us = obs.histogram(
            "serve_predict_us", "end-to-end predict() wall time").labels()
        self._m_warm_us = obs.histogram(
            "serve_warm_compute_us",
            "warm-path wall time per call (graph replay and copies on the "
            "card)").labels()
        self._m_probe_us = obs.histogram(
            "serve_cache_probe_us",
            "bucket-key + cache probe wall time").labels()
        self._m_hits = obs.counter(
            "serve_cache_hits_total",
            "query rows served from the cache").labels()
        self._m_misses = obs.counter(
            "serve_cache_misses_total",
            "query rows that ran the warm path").labels()
        self._m_bucket = obs.counter(
            "serve_padding_bucket_total",
            "batches served per power-of-two padding bucket",
            labels=("bucket",))
        self._bucket_children: dict = {}
        self._t_predict = obs.timer("serve.predict",
                                    to_histogram=self._m_predict_us)
        self._t_warm = obs.timer("serve.warm_compute",
                                 to_histogram=self._m_warm_us)

    # -- model hosting ------------------------------------------------------

    def load(self, directory: str, *, artifact_id: str | None = None,
             retries: int = 0, retry_backoff_s: float = 0.05) -> str:
        """Load an artifact onto this predictor's device and host it;
        returns its id.  ``retries`` re-attempts transient I/O failures with
        exponential backoff; validation errors are never retried."""
        loaded = load_artifact(directory, device=self.device,
                               artifact_id=artifact_id, retries=retries,
                               retry_backoff_s=retry_backoff_s)
        return self.add_model(loaded)

    def add_model(self, loaded: LoadedArtifact) -> str:
        """Host an already-loaded artifact (id from the artifact); its
        arrays must lie on this predictor's device."""
        if loaded.model.tables.device.type != self.device.type:
            raise ValueError(f"artifact {loaded.artifact_id!r} lies on "
                             f"{loaded.model.tables.device}, the predictor "
                             f"serves on {self.device}")
        hosted = _HostedModel(loaded, self.cache_entries)
        with self._lock:
            self._models[loaded.artifact_id] = hosted
            if self._default_id is None:
                self._default_id = loaded.artifact_id
        obs.counter("serve_models_loaded_total",
                    "artifacts hosted over the process lifetime").inc()
        if hosted.cache is not None:
            # pull-time gauges: read only when scraped
            cache = hosted.cache
            obs.gauge("serve_cache_entries", "live prediction-cache entries",
                      labels=("model",)).labels(loaded.artifact_id).set_fn(
                lambda cache=cache: cache.stats()["entries"])
            obs.gauge("serve_cache_evictions",
                      "prediction-cache evictions to date",
                      labels=("model",)).labels(loaded.artifact_id).set_fn(
                lambda cache=cache: cache.stats()["evictions"])
        return loaded.artifact_id

    def _hosted(self, artifact_id: str | None) -> _HostedModel:
        with self._lock:
            aid = artifact_id or self._default_id
            if aid is None or aid not in self._models:
                raise KeyError(f"no hosted model {aid!r}; "
                               f"have {sorted(self._models)}")
            return self._models[aid]

    def unload(self, artifact_id: str) -> bool:
        """Drop a hosted model with its graphs, caches and key memo.
        Predicts that already resolved the model finish on it (they hold
        it); its graphs and device buffers are released when the last one
        returns.  Returns whether the id was hosted."""
        with self._lock:
            hosted = self._models.pop(artifact_id, None)
            if self._default_id == artifact_id:
                self._default_id = min(self._models, default=None)
        return hosted is not None

    @property
    def artifact_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    # -- warm path ----------------------------------------------------------

    def _capture(self, hosted: _HostedModel, bucket: int) -> BucketGraph:
        """Run ``bucket`` once eagerly on the model's stream, then capture
        it (the caller holds the model's lock)."""
        d = hosted.loaded.model.lsh.d
        x_static = torch.zeros((bucket, d), dtype=torch.float32,
                               device=hosted.loaded.model.tables.device)
        with torch.cuda.stream(hosted.stream):
            hosted.fn(x_static)
        hosted.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with captured_launches() as launches, torch.cuda.graph(
                graph, pool=hosted.pool, stream=hosted.stream,
                capture_error_mode="thread_local"):
            out_static = hosted.fn(x_static)
        g = BucketGraph(graph, x_static, out_static, launches)
        hosted.graphs[bucket] = g
        return g

    def _predict_padded(self, hosted: _HostedModel, x: np.ndarray):
        """Pad to the power-of-two bucket, run it (the bucket's graph on the
        card), trim."""
        b = x.shape[0]
        bucket = padding_bucket(b, self.max_batch)
        ch = self._bucket_children.get(bucket)
        if ch is None:       # bind the labeled child once per padding bucket
            ch = self._bucket_children[bucket] = self._m_bucket.labels(bucket)
        ch.inc()
        if hosted.on_card:
            with hosted.lock:
                g = hosted.graphs.get(bucket) or self._capture(hosted, bucket)
                return g.run(x, hosted.stream)
        xp = np.zeros((bucket, x.shape[1]), np.float32)
        xp[:b] = x
        return hosted.fn(torch.from_numpy(xp)).numpy()[:b]

    def _predict_warm(self, hosted: _HostedModel, x: np.ndarray):
        with self._lock:
            self._n_predicts += 1
            call_idx = self._n_predicts
        serve_fault(self.fault_plan, call_idx)
        with self._t_warm():
            chunks = [self._predict_padded(hosted, x[i:i + self.max_batch])
                      for i in range(0, x.shape[0], self.max_batch)]
            return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def predict(self, x, *, artifact_id: str | None = None,
                use_cache: bool = True, validate: bool = True) -> np.ndarray:
        """Serve a (d,) point or (b, d) batch.

        ``validate`` rejects non-finite query rows with ``InvalidRequest``
        before they reach the model (never a silently-NaN prediction, never
        a poisoned cache entry)."""
        try:
            with self._t_predict():
                return self._predict(x, artifact_id=artifact_id,
                                     use_cache=use_cache, validate=validate)
        except BaseException as e:
            with self._lock:
                self._n_errors += 1
                self._last_error = repr(e)
            self._m_errors.inc()
            raise

    def _predict(self, x, *, artifact_id, use_cache, validate) -> np.ndarray:
        hosted = self._hosted(artifact_id)
        with self._lock:
            self._n_requests += 1
        self._m_requests.inc()
        x = np.asarray(x, np.float32)
        single = x.ndim == 1
        if single:
            x = x[None, :]
        if validate and not np.isfinite(x).all():
            bad = np.flatnonzero(~np.isfinite(x).all(axis=1))
            raise InvalidRequest(
                f"non-finite query row(s) {bad[:8].tolist()} "
                f"({len(bad)} of {x.shape[0]})")
        if hosted.cache is None or not use_cache:
            out = self._predict_warm(hosted, x)
            return out[0] if single else out

        t0 = perf_counter()
        keys = self._bucket_keys(hosted, x)
        found = hosted.cache.get_many(keys)
        self._m_probe_us.observe((perf_counter() - t0) * 1e6)
        if single and found[0] is not None:       # all-hit fast path
            self._m_hits.inc()
            v = found[0]
            # a copy, never the stored row: a caller's in-place edit must
            # not rewrite the cache (numpy scalars are immutable)
            return v.copy() if isinstance(v, np.ndarray) else v
        miss = [i for i, v in enumerate(found) if v is None]
        if len(found) > len(miss):
            self._m_hits.inc(len(found) - len(miss))
        if miss:
            self._m_misses.inc(len(miss))
            fresh = self._predict_warm(hosted, x[miss])
            hosted.cache.put_many([keys[i] for i in miss], list(fresh))
            for j, i in enumerate(miss):
                found[i] = fresh[j]
        out = np.stack(found)
        return out[0] if single else out

    def _bucket_keys(self, hosted: _HostedModel, x: np.ndarray) -> list[bytes]:
        """Bucket key per query row, through a raw-bytes -> key memo (the
        key is a pure function of the raw row).  Keys are computed on the
        NORMALIZED query, as the device featurizes it (numpy f32 mirrors
        the device's f32 normalization bitwise: both are IEEE sub/div)."""
        raw = [row.tobytes() for row in x]
        memo = hosted.keymemo.get_many(raw)
        miss = [i for i, k in enumerate(memo) if k is None]
        if miss:
            norm = hosted.loaded.norm
            xm = x[miss]
            if norm is not None:
                xm = ((xm - np.asarray(norm.x_mean, np.float32))
                      / np.asarray(norm.x_std, np.float32)).astype(np.float32)
            fresh = hosted.keyfn(xm)
            hosted.keymemo.put_many([raw[i] for i in miss], fresh)
            for j, i in enumerate(miss):
                memo[i] = fresh[j]
        return memo

    # -- graph management ---------------------------------------------------

    def warmup(self, *, artifact_id: str | None = None,
               sizes: tuple[int, ...] | None = None) -> int:
        """Capture every padding bucket (or just ``sizes``' buckets),
        largest first, so the first real request never pays a capture.
        Returns the number of graphs afterwards (0 on the CPU, where
        nothing is captured)."""
        hosted = self._hosted(artifact_id)
        if hosted.on_card:
            buckets = sorted({padding_bucket(s, self.max_batch)
                              for s in (sizes or self._all_buckets())},
                             reverse=True)
            with hosted.lock:
                for b in buckets:
                    if b not in hosted.graphs:
                        self._capture(hosted, b)
        return self.compile_count(artifact_id=artifact_id)

    def _all_buckets(self) -> list[int]:
        return [1 << p for p in range(self.max_batch.bit_length())]

    def compile_count(self, *, artifact_id: str | None = None) -> int:
        """Number of graphs captured for the hosted model: pinned flat
        across ragged request sizes (no new capture within a bucket)."""
        return len(self._hosted(artifact_id).graphs)

    def graph_stats(self, *, artifact_id: str | None = None) -> dict:
        """{bucket: {"launches", "launches_by_shape", "replays"}} of the
        hosted model's graphs: the kernel launches a replay makes, in all
        and by input shape, and how often the graph ran."""
        hosted = self._hosted(artifact_id)
        with hosted.lock:
            stats = {}
            for b, g in sorted(hosted.graphs.items()):
                counts, shapes = record_tally(g.launches)
                stats[b] = {"launches": counts, "launches_by_shape": shapes,
                            "replays": g.replays}
            return stats

    def cache_stats(self, *, artifact_id: str | None = None) -> dict | None:
        hosted = self._hosted(artifact_id)
        return None if hosted.cache is None else hosted.cache.stats()

    def clear_cache(self, *, artifact_id: str | None = None) -> None:
        """Drop the model's cached predictions AND key memo (stats keep
        accumulating)."""
        hosted = self._hosted(artifact_id)
        if hosted.cache is not None:
            hosted.cache.clear()
        if hosted.keymemo is not None:
            hosted.keymemo.clear()

    # -- health -------------------------------------------------------------

    def attach_batcher(self, batcher) -> None:
        """Fold an attached MicroBatcher's stats into ``health()``."""
        self._batcher = batcher

    def health(self) -> dict:
        """Serving health snapshot: hosted models, request/error counters,
        last error, and an attached batcher's queue depth, shed rate, p99
        and crash state."""
        with self._lock:
            snap = {
                "models": sorted(self._models),
                "requests": self._n_requests,
                "warm_calls": self._n_predicts,
                "errors": self._n_errors,
                "last_error": self._last_error,
            }
        batcher = self._batcher
        if batcher is not None:
            b = batcher.stats()
            snap["batcher"] = {k: b[k] for k in
                               ("queue_depth", "queue_depth_hwm", "shed",
                                "shed_rate", "deadline_expired", "p99_us",
                                "crashed", "last_error")}
        snap["ok"] = bool(snap["models"]) and not (
            batcher is not None and snap["batcher"]["crashed"])
        return snap
