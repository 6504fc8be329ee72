"""Sharded serving tier: KRR point predictions against tables sharded over a
(model_shards, data_shards) grid of ``torch.distributed`` ranks.

The JAX package's ``ShardedPredictor`` is one controller over a device
mesh; here every rank is a process (SPMD, ``launch/mesh.py``) and the
predictor is built on every rank, on its ``Mesh``:

* **rank 0 is the front end**: callers, the micro-batcher, the cache, the
  lifecycle's poll and HTTP metrics live there.  For each padded batch it
  broadcasts a small command (op, model, bucket, d, k) and the batch,
  runs its own share, and gathers the data ranks' outputs.
* **every other rank runs the worker loop** (``serve_forever``): it takes
  each command, runs its share, and leaves on the stop command (``stop``).
  Between commands a worker waits in a broadcast, so rank 0 sends a no-op
  command whenever none went out for ``heartbeat_s`` (60 s; under the
  group's collective timeout, NCCL's 10 min and gloo's 30 by default).
* **a failure fails the predict everywhere**: each rank's local half (B1
  and the index) runs first and every rank's status is gathered before
  any rank enters a collective of the exchange, so rank 0 raises the
  failing rank's error and the workers serve on.
* **every rank holds only its own table piece** ``shard_{i}_{j}`` of the
  sharded artifact (serve/artifact.py): the rank at (data j, model r) hosts
  piece (r - lo, j) of a model placed on model rows [lo, hi), whatever the
  rank order.  ``Mesh`` is laid out (data, model) and the JAX mesh (model,
  data); the piece mapping is the same.  Rank 0 also reads every model
  shard's LSH rows (small) for the cache keys.
* load and unload are commands too.  A load ends with an all-gathered
  status: a piece that fails on one rank fails the load on every rank
  (the error of the rank that failed is raised on rank 0), so no grid ever
  hosts mixed generations.

A predict runs ``make_krr_predict_hashjoin`` on each rank, eagerly (no
CUDA graph): each data rank featurizes its rows of the padded batch
against its m_loc instances (B1), routes the slot requests to the owners
and combines the values through the readout (B4), so on one model rank a
prediction is the single-host ``Predictor``'s bits.  ``dedup=False``
(default) sends raw requests (nothing can overflow); ``dedup=True`` takes
the training routing (B8 reads the values), with ``cap_factor`` 4.0 and
per-shard overflow counters.  Padding buckets are at least
``data_shards`` rows, so every data rank gets rows; the wire is f32.

The bucket-exact cache is per-shard aware, as in the JAX package: a key is
the row's bucket key plus the data shards its m slots touch and those
shards' piece versions, so ``bump_shard_version`` invalidates only the
entries that touch the bumped shard.

Control messages go over the default process group on its device (the
card under NCCL, the host under gloo).  Several ranks sharing one card
need gloo (NCCL refuses two ranks on one device); gloo carries the CUDA
tensors of the routing through the host.
"""
from __future__ import annotations

import threading
from time import perf_counter
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..backend import resolve_device
from ..core.bucket_fns import get_bucket_fn
from ..core.distributed import KRRStepConfig, make_krr_predict_hashjoin
from ..core.lsh import lsh_params_from_numpy
from ..errors import InvalidRequest, ServingError
from ..launch.mesh import Mesh, init_distributed, make_host_mesh
from .artifact import LoadedPiece, load_artifact_piece
from .cache import BucketKeyFn, PredictionCache
from .predictor import DEFAULT_MAX_BATCH, padding_bucket

# commands rank 0 broadcasts: a header of _HEADER int64s
# (op, model handle, bucket, d, k); _PING is the heartbeat's no-op
_STOP, _PREDICT, _LOAD, _UNLOAD, _PING = 0, 1, 2, 3, 4
_HEADER = 5
# the status of a collective load: ok, transient (a retry may help),
# structural (re-reading cannot fix it), anything else
_OK, _TRANSIENT, _STRUCTURAL, _OTHER = 0, 1, 2, 3


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """'2x2' -> (2, 2): (model_shards, data_shards)."""
    try:
        mm, nd = spec.lower().split("x")
        shape = (int(mm), int(nd))
    except ValueError:
        raise ValueError(f"mesh spec must look like '2x2', got {spec!r}")
    if shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"mesh shape must be positive, got {spec!r}")
    return shape


class _Share(NamedTuple):
    """What one rank computes for a hosted model (None fields on a rank
    outside the model's placement)."""

    predict: object              # make_krr_predict_hashjoin's function
    lsh: object                  # my m_loc LSH rows, on the device
    table: torch.Tensor | None   # my (m_loc, spp[, k]) piece
    norm: tuple | None           # (x_mean, x_std, y_mean, y_std) tensors


class _ShardedModel:
    """A hosted model: every rank's share, and on rank 0 the front end's
    state (keys, cache, per-shard counters)."""

    def __init__(self, handle: int, placement, share: _Share | None,
                 loaded: LoadedPiece | None, k: int):
        self.handle = handle
        self.placement = placement
        self.share = share
        self.loaded = loaded        # rank 0: manifest, norm, LSH rows
        self.k = k
        self.buckets: set[int] = set()
        self.keyfn = None
        self.cache = self.keymemo = None
        self.shard_versions = self.overflow = None

    @property
    def manifest(self) -> dict:
        return self.loaded.manifest

    @property
    def d(self) -> int:
        return int(self.loaded.lsh_host["w"].shape[1])


def _status(err: BaseException | None) -> int:
    import zipfile
    if err is None:
        return _OK
    if isinstance(err, (OSError, zipfile.BadZipFile)):
        return _TRANSIENT
    if isinstance(err, (ValueError, KeyError)):
        return _STRUCTURAL
    return _OTHER


class ShardedPredictor:
    """Hosts sharded models on a (model_shards, data_shards) grid of ranks
    and serves point predictions with the API of ``Predictor`` (predict /
    warmup / compile_count / cache_stats / attach_batcher / health) on
    rank 0, so the MicroBatcher, the lifecycle and launch/krr_serve.py
    front either.

    Build it on every rank of the process group: with ``mesh`` (its
    ``model`` x ``data`` must be ``mesh_shape``), or from ``mesh_shape``
    over the initialised group (a group of one on ``device`` when none is,
    None: the card).  Rank 0 serves; every other rank calls
    ``serve_forever`` until rank 0 calls ``stop``.  ``add_model`` is
    collective (every rank, before the workers serve); ``load`` and
    ``unload`` on rank 0 reach the workers as commands.
    """

    def __init__(self, *, mesh_shape: tuple[int, int] | None = None,
                 mesh: Mesh | None = None, device=None,
                 max_batch: int = DEFAULT_MAX_BATCH, cache_entries: int = 0,
                 cap_factor: float = 4.0, dedup: bool = False,
                 heartbeat_s: float | None = 60.0):
        if mesh_shape is None and mesh is None:
            raise ValueError("give mesh_shape, mesh, or both")
        shape = (tuple(int(v) for v in mesh_shape) if mesh_shape is not None
                 else (mesh.model, mesh.data))
        mm, nd = shape
        if nd & (nd - 1):
            raise ValueError(f"data_shards must be a power of two, got {nd}")
        if max_batch & (max_batch - 1) or max_batch < nd:
            raise ValueError(f"max_batch must be a power of two >= "
                             f"data_shards, got {max_batch} vs {nd}")
        if heartbeat_s is not None and not heartbeat_s > 0:
            raise ValueError(f"heartbeat_s must be positive or None, got "
                             f"{heartbeat_s}")
        if mesh is None:
            dev = resolve_device(device)
            if not dist.is_initialized():
                dev = init_distributed(dev)
            elif dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            world = dist.get_world_size()
            if world != mm * nd:
                raise ValueError(f"mesh {mm}x{nd} needs {mm * nd} ranks, "
                                 f"the process group has {world}")
            mesh = make_host_mesh(mm, device=dev)
        if (mesh.model, mesh.data) != shape:
            raise ValueError(f"mesh {mm}x{nd} asked for on a "
                             f"{mesh.model}x{mesh.data} grid")
        self.mesh = mesh
        self.mesh_shape = shape
        self.device = mesh.device
        self.rank = dist.get_rank()
        self.max_batch = int(max_batch)
        self.cache_entries = int(cache_entries)
        # dedup=False is the interactive default (no layout sort, no routing
        # scatters, nothing to overflow); dedup=True is the training
        # routing's deduplicated wire, with headroom-first capacity
        self.dedup = bool(dedup)
        self.cap_factor = float(cap_factor)
        self._ctrl = (mesh.device if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
        self._groups: dict = {}            # placement -> model groups
        self._handles: dict[int, _ShardedModel] = {}
        self._next_handle = 0
        self._models: dict[str, _ShardedModel] = {}    # rank 0: by id
        self._default_id: str | None = None
        self._lock = threading.Lock()      # front-end state
        self._grid = threading.Lock()      # one command at a time
        self._stopped = False
        # rank 0 sends a no-op command whenever none went out for this
        # long, so no worker waits in its broadcast past the group's
        # collective timeout (NCCL's default 10 min, gloo's 30); None: off
        self.heartbeat_s = None if heartbeat_s is None else float(heartbeat_s)
        self._serving = False              # the grid takes commands
        self._last_send = 0.0              # rank 0's last command
        self._beat_stop = threading.Event()
        self._beat: threading.Thread | None = None
        self._n_requests = 0
        self._n_predicts = 0
        self._n_errors = 0
        self._last_error: str | None = None
        self._batcher = None
        # the single-host Predictor's metric families: one schema across
        # serving tiers
        self._m_requests = obs.counter(
            "serve_requests_total", "predict() calls accepted").labels()
        self._m_errors = obs.counter(
            "serve_errors_total", "predict() calls that raised").labels()
        self._m_predict_us = obs.histogram(
            "serve_predict_us", "end-to-end predict() wall time").labels()
        self._m_warm_us = obs.histogram(
            "serve_warm_compute_us",
            "warm-path wall time per call (the grid's command, every "
            "rank's share, the gather)").labels()
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

    @property
    def is_front(self) -> bool:
        """True on rank 0, which serves callers."""
        return self.rank == 0

    def _need_front(self, what: str) -> None:
        if not self.is_front:
            raise ServingError(f"{what} runs on rank 0 (the front end); "
                               f"rank {self.rank} runs serve_forever()")
        if self._stopped:
            raise ServingError(f"{what}: the grid was stopped")

    # -- the control channel ------------------------------------------------

    def _send(self, op: int, handle: int = 0, bucket: int = 0, d: int = 0,
              k: int = 0) -> None:
        """Rank 0, holding ``_grid``: broadcast a command's header.  The
        first command starts the heartbeat (when there are workers)."""
        hdr = torch.tensor([op, handle, bucket, d, k],
                           dtype=torch.int64, device=self._ctrl)
        dist.broadcast(hdr, 0)
        self._last_send = perf_counter()
        if not self._serving:
            self._serving = True
            if self.heartbeat_s is not None and op != _STOP and \
                    dist.get_world_size() > 1:
                self._beat = threading.Thread(
                    target=self._heartbeat, name="sharded-heartbeat",
                    daemon=True)
                self._beat.start()

    def _heartbeat(self) -> None:
        """Rank 0's keepalive: a no-op command ``heartbeat_s`` after the
        last command, for as long as the grid serves."""
        wait = self.heartbeat_s
        while not self._beat_stop.wait(wait):
            with self._grid:
                if self._stopped or not dist.is_initialized():
                    return
                idle = perf_counter() - self._last_send
                if idle >= self.heartbeat_s:
                    self._send(_PING)
                    idle = 0.0
            wait = self.heartbeat_s - idle

    def _recv(self) -> list[int]:
        hdr = torch.empty(_HEADER, dtype=torch.int64, device=self._ctrl)
        dist.broadcast(hdr, 0)
        return hdr.tolist()

    def serve_forever(self) -> None:
        """The worker loop of every rank but 0: run rank 0's commands until
        it stops the grid.  A load that fails here is reported in the
        load's status (and raised on rank 0); any other failure raises on
        this rank."""
        if self.is_front:
            raise ServingError("rank 0 is the front end: it serves callers "
                               "and stops the workers with stop()")
        self._serving = True
        while True:
            op, handle, bucket, d, k = self._recv()
            if op == _STOP:
                self._stopped = True
                return
            if op == _PING:
                continue
            if op == _PREDICT:
                self._run_predict(handle, None, bucket, d, k)
            elif op == _LOAD:
                box = [None]
                dist.broadcast_object_list(box, 0)
                try:
                    self._load_collective(*box[0])
                except Exception as e:
                    # every rank saw the status; rank 0 raises it
                    self._last_error = repr(e)
            elif op == _UNLOAD:
                self._handles.pop(handle, None)
            else:
                raise ServingError(f"unknown grid command {op}")

    def stop(self) -> None:
        """Rank 0: send the workers the stop command (they leave
        ``serve_forever``); the predictor serves no more."""
        if not self.is_front or self._stopped:
            return
        with self._grid:
            self._send(_STOP)
            self._stopped = True
        self._beat_stop.set()
        if self._beat is not None:
            self._beat.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- model hosting ------------------------------------------------------

    def _placement(self, placement) -> tuple[int, int]:
        mm = self.mesh_shape[0]
        lo, hi = placement or (0, mm)
        lo, hi = int(lo), int(hi)
        if not (0 <= lo < hi <= mm):
            raise ValueError(f"placement {lo, hi} outside model axis "
                             f"[0, {mm})")
        return lo, hi

    def _submesh(self, lo: int, hi: int) -> Mesh:
        """The grid of a model on model rows [lo, hi): my data group, and a
        model group of the ranks [lo, hi) of my data row (created by every
        rank, in one order, the first time a placement is seen)."""
        mm, nd = self.mesh_shape
        if (lo, hi) == (0, mm):
            return self.mesh
        if (lo, hi) not in self._groups:
            groups = [dist.new_group([j * mm + i for i in range(lo, hi)])
                      for j in range(nd)]
            self._groups[lo, hi] = groups
        m = self.mesh
        return m._replace(model=hi - lo, model_rank=m.model_rank - lo,
                          model_group=self._groups[lo, hi][m.data_rank])

    def _share(self, piece: LoadedPiece, lo: int, hi: int) -> _Share:
        """My share of a model whose piece this rank holds."""
        mf = piece.manifest
        cfg = KRRStepConfig(m=int(mf["m"]), table_size=int(mf["table_size"]),
                            lam=0.0, cg_iters=0)
        fn = make_krr_predict_hashjoin(
            self._submesh(lo, hi), cfg, get_bucket_fn(mf["bucket_name"]),
            cap_factor=self.cap_factor, payload_dtype=torch.float32,
            with_stats=True, dedup=self.dedup)
        norm = None
        if piece.norm is not None:
            def f32(v):
                return torch.from_numpy(np.asarray(v, np.float32)).to(
                    self.device)
            n = piece.norm
            norm = (f32(n.x_mean), f32(n.x_std), f32(n.y_mean), f32(n.y_std))
        return _Share(predict=fn, lsh=piece.lsh, table=piece.table,
                      norm=norm)

    def _host(self, handle: int, lo: int, hi: int, loaded,
              artifact_id: str) -> None:
        """Host ``loaded`` (a LoadedPiece of this rank, or None outside the
        placement; rank 0 always holds the manifest and LSH rows)."""
        member = lo <= self.mesh.model_rank < hi
        self._submesh(lo, hi)          # collective the first time
        share = self._share(loaded, lo, hi) if member else None
        k = int(loaded.manifest.get("k", 0)) if loaded is not None else 0
        hosted = _ShardedModel(handle, (lo, hi), share,
                               loaded if self.is_front else None, k)
        self._handles[handle] = hosted
        if self.is_front:
            self._front_state(hosted, artifact_id)

    def add_model(self, loaded: LoadedPiece, *,
                  placement: tuple[int, int] | None = None,
                  artifact_id: str | None = None) -> str:
        """Host a piece already loaded in this process
        (``load_artifact_piece``: this rank's piece, rank 0's with
        ``lsh_host``; None on a rank outside the placement that is not
        rank 0), on model rows ``placement=[lo, hi)`` (default: the whole
        model axis).  Collective: every rank calls it, before rank 0 sends
        its first command.  Returns the artifact id (rank 0's)."""
        if self._serving:
            raise ServingError("add_model is collective: call it on every "
                               "rank before the grid serves (load() "
                               "reaches a serving grid)")
        if loaded is not None and not isinstance(loaded, LoadedPiece):
            raise TypeError(f"add_model hosts this rank's LoadedPiece "
                            f"(load_artifact_piece), got "
                            f"{type(loaded).__name__}")
        lo, hi = self._placement(placement)
        nd = self.mesh_shape[1]
        if loaded is not None and loaded.mesh_shape != (hi - lo, nd):
            raise ValueError(f"artifact sharded for mesh "
                             f"{loaded.mesh_shape}, placement {lo, hi} on a "
                             f"{self.mesh_shape[0]}x{nd} mesh wants "
                             f"{(hi - lo, nd)}")
        aid = None if loaded is None else (artifact_id or loaded.artifact_id)
        handle = self._next_handle
        self._next_handle += 1
        self._host(handle, lo, hi, loaded, aid)
        return aid

    def load(self, directory: str, *, artifact_id: str | None = None,
             placement: tuple[int, int] | None = None, retries: int = 0,
             retry_backoff_s: float = 0.05) -> str:
        """Load a sharded artifact onto the grid, each rank its own piece,
        and host it on model rows ``placement=[lo, hi)`` (default: the
        whole model axis).  The artifact must have been exported for
        exactly the (hi - lo, data_shards) grid.  ``retries`` re-attempts
        transient read failures on each rank.  A failure on any rank fails
        the load on every rank and raises here: the failing rank's
        ValueError (structural) or OSError (transient) as such."""
        self._need_front("load")
        lo, hi = self._placement(placement)
        with self._grid:
            handle = self._next_handle
            self._next_handle += 1
            args = (handle, directory, artifact_id, lo, hi, retries,
                    retry_backoff_s)
            self._send(_LOAD, handle)
            dist.broadcast_object_list([args], 0)
            return self._load_collective(*args)

    def _load_collective(self, handle, directory, artifact_id, lo, hi,
                         retries, backoff) -> str | None:
        """Every rank: read my piece (rank 0 also every model shard's LSH
        rows), share the status, host the model if every rank succeeded,
        else raise the first failing rank's error everywhere."""
        self._next_handle = max(self._next_handle, handle + 1)
        nd = self.mesh_shape[1]
        member = lo <= self.mesh.model_rank < hi
        err, loaded = None, None
        try:
            if member or self.is_front:
                piece = (self.mesh.model_rank - lo if member else 0,
                         self.mesh.data_rank)
                loaded = load_artifact_piece(
                    directory, mesh_shape=(hi - lo, nd), piece=piece,
                    device=self.device, artifact_id=artifact_id,
                    with_table=member, with_lsh_host=self.is_front,
                    retries=retries, retry_backoff_s=backoff)
        except Exception as e:
            err = e
        statuses = [None] * dist.get_world_size()
        dist.all_gather_object(statuses, (_status(err), repr(err)))
        bad = [(r, s) for r, s in enumerate(statuses) if s[0] != _OK]
        if bad:
            if err is not None:
                raise err
            rank, (code, text) = bad[0]
            msg = f"rank {rank} failed to load its piece: {text}"
            if code == _TRANSIENT:
                raise OSError(msg)
            if code == _STRUCTURAL:
                raise ValueError(msg)
            raise ServingError(msg)
        aid = None if loaded is None else (artifact_id or loaded.artifact_id)
        self._host(handle, lo, hi, loaded, aid)
        return aid

    def _front_state(self, hosted: _ShardedModel, aid: str) -> None:
        """Rank 0: the model's keys, cache, per-shard counters and gauges."""
        nd = self.mesh_shape[1]
        h = hosted.loaded.lsh_host
        lsh = lsh_params_from_numpy(h["w"], h["z"], h["r1"], h["r2"], "cpu")
        hosted.keyfn = BucketKeyFn(
            lsh, get_bucket_fn(hosted.manifest["bucket_name"]))
        if self.cache_entries > 0:
            hosted.cache = PredictionCache(self.cache_entries)
            hosted.keymemo = PredictionCache(self.cache_entries)
        hosted.shard_versions = np.zeros(nd, np.int64)
        hosted.overflow = np.zeros(nd, np.int64)
        with self._lock:
            self._models[aid] = hosted
            if self._default_id is None:
                self._default_id = aid
        obs.counter("serve_models_loaded_total",
                    "artifacts hosted over the process lifetime").inc()
        if hosted.cache is not None:
            cache = hosted.cache
            obs.gauge("serve_cache_entries", "live prediction-cache entries",
                      labels=("model",)).labels(aid).set_fn(
                lambda cache=cache: cache.stats()["entries"])
            obs.gauge("serve_cache_evictions",
                      "prediction-cache evictions to date",
                      labels=("model",)).labels(aid).set_fn(
                lambda cache=cache: cache.stats()["evictions"])
        # per-shard pull-time gauges, registered at load so the series
        # exist (at 0) in broadcast mode too, where overflow cannot happen
        ovf = obs.gauge("serve_shard_overflow_dropped",
                        "distinct buckets dropped past routing capacity, "
                        "per data shard", labels=("model", "shard"))
        ver = obs.gauge("serve_shard_piece_version",
                        "hot-swap version of each data shard's table piece",
                        labels=("model", "shard"))
        for j in range(nd):
            ovf.labels(aid, j).set_fn(
                lambda h=hosted, j=j: int(h.overflow[j]))
            ver.labels(aid, j).set_fn(
                lambda h=hosted, j=j: int(h.shard_versions[j]))

    def _hosted(self, artifact_id: str | None) -> _ShardedModel:
        with self._lock:
            aid = artifact_id or self._default_id
            if aid is None or aid not in self._models:
                raise KeyError(f"no hosted model {aid!r}; "
                               f"have {sorted(self._models)}")
            return self._models[aid]

    def unload(self, artifact_id: str) -> bool:
        """Drop a hosted model on every rank (its pieces, caches and
        counters).  Returns whether the id was hosted."""
        self._need_front("unload")
        with self._lock:
            hosted = self._models.pop(artifact_id, None)
            if self._default_id == artifact_id:
                self._default_id = min(self._models, default=None)
        if hosted is None:
            return False
        with self._grid:
            self._send(_UNLOAD, hosted.handle)
            self._handles.pop(hosted.handle, None)
        return True

    @property
    def artifact_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def bump_shard_version(self, shard: int, *,
                           artifact_id: str | None = None) -> None:
        """Record that data shard ``shard``'s table piece changed (hot
        swap): cached entries whose slots touch it stop matching,
        everything else keeps hitting."""
        hosted = self._hosted(artifact_id)
        if not 0 <= shard < self.mesh_shape[1]:
            raise ValueError(f"shard {shard} outside [0, "
                             f"{self.mesh_shape[1]})")
        with self._lock:
            hosted.shard_versions[shard] += 1

    # -- the warm (sharded) path ----------------------------------------------

    def _bucket(self, n: int) -> int:
        # every data shard must receive rows: bucket >= data_shards
        return max(self.mesh_shape[1], padding_bucket(n, self.max_batch))

    def _run_predict(self, handle: int, xp, bucket: int, d: int, k: int):
        """Every rank: my share of one padded batch (rank 0 passes it as a
        host array; the others receive it).  The local half (B1 and the
        index) runs first and every rank's status is gathered, so a rank
        whose half failed fails the predict on every rank before any
        enters a collective of the exchange: rank 0 raises that rank's
        error, the workers serve on.  Then the exchange and the gather
        (a failure inside the exchange meets the group's timeout).
        Returns, on rank 0, the (bucket[, k]) predictions and each data
        shard's dropped buckets."""
        mm, nd = self.mesh_shape
        if xp is None:
            x = torch.empty((bucket, d), dtype=torch.float32,
                            device=self._ctrl)
        else:
            x = torch.from_numpy(xp).to(self._ctrl)
        dist.broadcast(x, 0)
        n_loc = bucket // nd
        tail = (k,) if k else ()
        hosted = share = idx = err = None
        try:
            hosted = self._handles[handle]
            share = hosted.share
            if share is not None:
                j = self.mesh.data_rank
                xl = x[j * n_loc:(j + 1) * n_loc].to(self.device)
                if share.norm is not None:
                    x_mean, x_std = share.norm[:2]
                    xl = (xl - x_mean) / x_std
                idx = share.predict.index(xl, share.lsh)
        except Exception as e:
            err = e
        failed = self._failed_rank(err)
        if failed is not None:
            rank, text = failed
            with self._lock:
                self._last_error = text
                if not self.is_front:
                    self._n_errors += 1
            if not self.is_front:
                return None
            if err is not None:
                raise err
            raise ServingError(f"rank {rank} failed its share of the "
                               f"predict: {text}")
        if share is not None:
            out, dropped = share.predict.exchange(idx, share.table)
            if share.norm is not None:
                y_mean, y_std = share.norm[2:]
                out = out * y_std + y_mean
            out = out.to(self._ctrl)
            dropped = dropped.to(torch.int64).to(self._ctrl)
        else:
            out = torch.zeros((n_loc,) + tail, dtype=torch.float32,
                              device=self._ctrl)
            dropped = torch.zeros(1, dtype=torch.int64, device=self._ctrl)
        world = dist.get_world_size()
        outs = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(outs, out.contiguous())
        drops = None
        if self.dedup:
            drops = [torch.empty_like(dropped) for _ in range(world)]
            dist.all_gather(drops, dropped)
        if not self.is_front:
            return None
        lo = hosted.placement[0]
        full = torch.cat([outs[j * mm + lo] for j in range(nd)]).cpu().numpy()
        per_shard = (np.asarray([int(drops[j * mm + lo]) for j in range(nd)],
                                np.int64) if drops is not None else None)
        return full, per_shard

    def _failed_rank(self, err: BaseException | None):
        """Every rank: gather every rank's status (one int each); the first
        failing rank and its error text, or None when none failed."""
        world = dist.get_world_size()
        if world == 1:
            return None if err is None else (0, repr(err))
        st = torch.tensor([0 if err is None else 1], dtype=torch.int64,
                          device=self._ctrl)
        sts = [torch.empty_like(st) for _ in range(world)]
        dist.all_gather(sts, st)
        bad = [r for r, t in enumerate(torch.cat(sts).tolist()) if t]
        if not bad:
            return None
        texts = [None] * world
        dist.all_gather_object(texts, None if err is None else repr(err))
        return bad[0], texts[bad[0]]

    def _predict_padded(self, hosted: _ShardedModel, x: np.ndarray):
        b = x.shape[0]
        bucket = self._bucket(b)
        ch = self._bucket_children.get(bucket)
        if ch is None:       # bind the labeled child once per padding bucket
            ch = self._bucket_children[bucket] = self._m_bucket.labels(bucket)
        ch.inc()
        xp = np.zeros((bucket, x.shape[1]), np.float32)
        xp[:b] = x
        with self._grid:
            if self._stopped:
                raise ServingError("the grid was stopped")
            if self._handles.get(hosted.handle) is not hosted:
                raise ServingError("the model was unloaded")
            self._send(_PREDICT, hosted.handle, bucket, x.shape[1],
                       hosted.k)
            out, dropped = self._run_predict(hosted.handle, xp, bucket,
                                             x.shape[1], hosted.k)
        with self._lock:
            hosted.buckets.add(bucket)
            if dropped is not None:
                hosted.overflow[:] += dropped
        return out[:b]

    def _predict_warm(self, hosted: _ShardedModel, x: np.ndarray):
        with self._lock:
            self._n_predicts += 1
        with self._t_warm():
            chunks = [self._predict_padded(hosted, x[i:i + self.max_batch])
                      for i in range(0, x.shape[0], self.max_batch)]
            return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def predict(self, x, *, artifact_id: str | None = None,
                use_cache: bool = True, validate: bool = True) -> np.ndarray:
        """Serve a (d,) point or (b, d) batch against the sharded tables
        (rank 0).  ``validate`` rejects non-finite rows with
        ``InvalidRequest`` before any rank sees them."""
        self._need_front("predict")
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
        keys = self._sharded_keys(hosted, x)
        found = hosted.cache.get_many(keys)
        self._m_probe_us.observe((perf_counter() - t0) * 1e6)
        miss = [i for i, v in enumerate(found) if v is None]
        if len(found) > len(miss):
            self._m_hits.inc(len(found) - len(miss))
        if miss:
            self._m_misses.inc(len(miss))
            fresh = self._predict_warm(hosted, x[miss])
            hosted.cache.put_many([keys[i] for i in miss], list(fresh))
            for j, i in enumerate(miss):
                found[i] = fresh[j]
        # copies, never the stored rows: a caller's in-place edit must not
        # rewrite the cache
        out = np.stack([v.copy() if isinstance(v, np.ndarray) else v
                        for v in found])
        return out[0] if single else out

    def _sharded_keys(self, hosted: _ShardedModel,
                      x: np.ndarray) -> list[bytes]:
        """Per-row sharded cache key: the bucket key, the touched shards'
        ids and their current piece versions.  (base key, touch set) is a
        pure function of the raw row and memoizes; the version suffix is
        applied per lookup, so a bump takes effect at once."""
        raw = [row.tobytes() for row in x]
        memo = hosted.keymemo.get_many(raw)
        miss = [i for i, k in enumerate(memo) if k is None]
        if miss:
            norm = hosted.loaded.norm
            xm = x[miss]
            if norm is not None:
                xm = ((xm - np.asarray(norm.x_mean, np.float32))
                      / np.asarray(norm.x_std, np.float32)).astype(np.float32)
            fresh = hosted.keyfn.keys_with_touch(
                xm, table_size=int(hosted.manifest["table_size"]),
                n_shards=self.mesh_shape[1])
            hosted.keymemo.put_many([raw[i] for i in miss], fresh)
            for j, i in enumerate(miss):
                memo[i] = fresh[j]
        with self._lock:
            versions = hosted.shard_versions.copy()
        out = []
        for base, touched in memo:
            tv = np.asarray([(j, versions[j]) for j in touched], np.int64)
            out.append(base + b"|shards" + tv.tobytes())
        return out

    # -- buckets ------------------------------------------------------------

    def warmup(self, *, artifact_id: str | None = None,
               sizes: tuple[int, ...] | None = None) -> int:
        """Run every padding bucket (or ``sizes``' buckets) once on the
        grid, so the first real request at a bucket meets warm allocator
        caches on every rank.  Returns ``compile_count``."""
        hosted = self._hosted(artifact_id)
        buckets = sorted({self._bucket(s) for s in
                          (sizes or self._all_buckets())})
        for b in buckets:
            self._predict_padded(hosted, np.zeros((b, hosted.d), np.float32))
        return self.compile_count(artifact_id=artifact_id)

    def _all_buckets(self) -> list[int]:
        return [1 << p for p in range(self.max_batch.bit_length())]

    def compile_count(self, *, artifact_id: str | None = None) -> int:
        """Distinct padding buckets the model has run (each runs eagerly;
        nothing is captured): flat across ragged sizes within a bucket."""
        hosted = self._hosted(artifact_id)
        with self._lock:
            return len(hosted.buckets)

    def cache_stats(self, *, artifact_id: str | None = None) -> dict | None:
        hosted = self._hosted(artifact_id)
        return None if hosted.cache is None else hosted.cache.stats()

    def clear_cache(self, *, artifact_id: str | None = None) -> None:
        """Drop the model's cached predictions and key memo."""
        hosted = self._hosted(artifact_id)
        if hosted.cache is not None:
            hosted.cache.clear()
            hosted.keymemo.clear()

    # -- health -------------------------------------------------------------

    def attach_batcher(self, batcher) -> None:
        self._batcher = batcher

    def health(self) -> dict:
        """Serving health with the sharded tier's observables: the grid's
        shape, each model's placement, per-data-shard overflow counters
        (distinct buckets dropped past routing capacity: nonzero means
        cap_factor needs headroom) and piece versions, and the attached
        batcher's queue state."""
        with self._lock:
            snap = {
                "models": sorted(self._models),
                "mesh": {"model": self.mesh_shape[0],
                         "data": self.mesh_shape[1]},
                "requests": self._n_requests,
                "warm_calls": self._n_predicts,
                "errors": self._n_errors,
                "last_error": self._last_error,
                "shards": {
                    aid: {"placement": list(h.placement),
                          "overflow": h.overflow.tolist(),
                          "piece_versions": h.shard_versions.tolist()}
                    for aid, h in self._models.items()},
            }
        batcher = self._batcher
        if batcher is not None:
            b = batcher.stats()
            snap["batcher"] = {k: b[k] for k in
                               ("queue_depth", "queue_depth_hwm", "shed",
                                "shed_rate", "deadline_expired", "p99_us",
                                "crashed", "last_error")}
        snap["ok"] = bool(snap["models"]) and not self._stopped and not (
            batcher is not None and snap["batcher"]["crashed"])
        return snap
