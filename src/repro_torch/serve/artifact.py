"""Serving artifacts: a fitted WLSH-KRR model as an on-disk, versioned thing,
in the JAX package's format (``repro.serve.artifact``), so an artifact
exported by either package loads in the other.

Export writes everything prediction needs (the m LSH instances, the
bucket-load tables, the bucket function and table geometry, optional
normalization stats, the fit's provenance) through the checkpoint store's
atomic tmp-dir + rename layout.  The checkpoint "step" carries the artifact
FORMAT version: ``latest_step`` picks the newest format a writer produced,
and the loader refuses formats newer than it knows.

``meta["backend"]`` holds a name the JAX package's loader accepts: the
port writes ``pallas`` for a fit on the card (its kernels are the Pallas
kernels' counterparts) and ``reference`` for one on the CPU, and records
itself under ``meta["framework"] = "torch"``.  The port's loader accepts
every JAX backend name: the device the arrays are put on picks the path.

Load validates every array shape against the metadata manifest, the
metadata against itself, and the tables for non-finite values (on the host,
span ``io.validate_artifact``), then puts the arrays on the caller's device
(None: the card).

Sharded artifacts (``export_artifact_sharded``) are the JAX package's piece
grids: a manifest and one checkpoint per (model shard, data shard) piece.
``load_artifact_sharded`` reassembles the whole model (either package's
export); ``load_artifact_piece`` reads one rank's piece, as the SPMD
serving grid (serve/sharded.py) loads it.
"""
from __future__ import annotations

import json
import os
import time
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..backend import resolve_device
from ..checkpoint import (atomic_write_json, latest_step, restore_checkpoint,
                          save_checkpoint)
from ..core.bucket_fns import BUCKET_FNS
from ..core.krr import WLSHKRRModel, model_operator
from ..core.lsh import lsh_params_from_numpy
from ..core.operator import WLSHOperator

ARTIFACT_FORMAT = 1          # the JAX package's format version
_DTYPES = {"lsh_w": np.float32, "lsh_z": np.float32,
           "lsh_r1": np.uint32, "lsh_r2": np.uint32,
           "beta": np.float32, "tables": np.float32,
           "x_mean": np.float32, "x_std": np.float32,
           "y_mean": np.float32, "y_std": np.float32}


class Normalization(NamedTuple):
    """Optional request/response normalization baked into an artifact: the
    predictor serves ``(x - x_mean) / x_std`` through the model and returns
    ``yhat * y_std + y_mean``."""

    x_mean: np.ndarray   # (d,)
    x_std: np.ndarray    # (d,)
    y_mean: float
    y_std: float


class LoadedArtifact(NamedTuple):
    artifact_id: str
    model: WLSHKRRModel
    operator: WLSHOperator   # on the device the arrays were put on
    norm: Normalization | None
    meta: dict


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _model_arrays(model: WLSHKRRModel, *,
                  include_beta: bool) -> dict[str, np.ndarray]:
    tables = _host(model.tables).astype(np.float32, copy=False)
    # prediction never reads beta, the one array that scales with the
    # training set; a zero-row stand-in keeps the manifest's column count
    beta = (_host(model.beta).astype(np.float32, copy=False) if include_beta
            else np.zeros((0,) + tables.shape[2:], np.float32))
    lsh = model.lsh
    return {"lsh_w": _host(lsh.w).astype(np.float32, copy=False),
            "lsh_z": _host(lsh.z).astype(np.float32, copy=False),
            "lsh_r1": _host(lsh.r1).astype(np.uint32, copy=False),
            "lsh_r2": _host(lsh.r2).astype(np.uint32, copy=False),
            "beta": beta,
            "tables": tables}


GOLDEN_QUERIES = 16          # default canary set size captured at export
GOLDEN_TOL = 1e-4            # default agreement tolerance
_GOLDEN_SEED = 1053          # the JAX package's: both draw the same points


def _golden_block(model: WLSHKRRModel, norm: Normalization | None, *,
                  k: int, x=None, tol: float) -> dict:
    """Canary golden set: ``k`` query points and the model's own
    predictions at them, through the normalize -> featurize/readout ->
    denormalize pipeline the predictor serves.  ``x`` defaults to points in
    [0, 2)^d from a fixed seed (the JAX package's)."""
    d = int(model.lsh.d)
    if x is None:
        rng = np.random.default_rng(_GOLDEN_SEED)
        x = rng.uniform(0.0, 2.0, size=(k, d)).astype(np.float32)
    else:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != d:
            raise ValueError(f"golden_x must be (k, {d}), got {x.shape}")
        x = x[:k] if k else x
    xq = x
    if norm is not None:
        xq = ((x - np.asarray(norm.x_mean, np.float32))
              / np.asarray(norm.x_std, np.float32)).astype(np.float32)
    op = model_operator(model)
    y = _host(op.predict_from_buckets(op.featurize_buckets(xq),
                                      model.tables))
    if norm is not None:
        y = y * np.float32(norm.y_std) + np.float32(norm.y_mean)
    return {"x": x.tolist(), "y": np.asarray(y, np.float32).tolist(),
            "tol": float(tol)}


def export_artifact(directory: str, model: WLSHKRRModel, *,
                    artifact_id: str | None = None,
                    norm: Normalization | None = None,
                    extra_meta: dict | None = None,
                    include_beta: bool = True,
                    golden_queries: int = GOLDEN_QUERIES,
                    golden_x=None, golden_tol: float = GOLDEN_TOL) -> str:
    """Atomically write ``model`` (and optional normalization) to
    ``directory``; returns the artifact id (default: the directory's
    basename).  ``include_beta=False`` drops the training solution.
    ``golden_queries`` canary points and their predictions ride the meta
    (0 opts out).  The meta's ``export_version`` is the previous export's
    + 1, so a reload watcher can tell a re-publish from the version it
    serves."""
    with obs.span("io.export_artifact",
                  to_histogram=obs.histogram(
                      "io_artifact_export_us",
                      "artifact export wall time")):
        arrays = _model_arrays(model, include_beta=include_beta)
        if norm is not None:
            arrays["x_mean"] = np.asarray(norm.x_mean, np.float32).reshape(-1)
            arrays["x_std"] = np.asarray(norm.x_std, np.float32).reshape(-1)
            arrays["y_mean"] = np.asarray(norm.y_mean, np.float32).reshape(())
            arrays["y_std"] = np.asarray(norm.y_std, np.float32).reshape(())
        artifact_id = artifact_id or os.path.basename(
            os.path.normpath(directory))
        on_card = model.tables.device.type == "cuda"
        meta = {"kind": "wlsh_krr_artifact",
                "format": ARTIFACT_FORMAT,
                "artifact_id": artifact_id,
                "export_version": _previous_version(directory) + 1,
                "bucket_name": model.bucket_name,
                "table_size": int(model.table_size),
                "backend": "pallas" if on_card else "reference",
                "framework": "torch",
                "precond": model.precond,
                "cg_iters": int(_host(model.cg_iters)),
                "cg_resnorm": _host(model.cg_resnorm).tolist(),
                "has_norm": norm is not None,
                "has_beta": include_beta,
                "arrays": {k: list(v.shape) for k, v in arrays.items()},
                **(extra_meta or {})}
        if golden_queries > 0 or golden_x is not None:
            meta["golden"] = _golden_block(model, norm, k=golden_queries,
                                           x=golden_x, tol=golden_tol)
        save_checkpoint(directory, ARTIFACT_FORMAT, arrays, meta)
        obs.counter("io_artifact_exports_total", "artifacts exported",
                    labels=("kind",)).labels("single").inc()
        return artifact_id


def _previous_version(directory: str) -> int:
    step = latest_step(directory)
    if step is None:
        return 0
    try:
        return int(_read_meta(directory, step).get("export_version", 0))
    except (OSError, ValueError):
        return 0


def _validate(meta: dict, arrays: dict[str, np.ndarray]) -> None:
    if meta.get("kind") != "wlsh_krr_artifact":
        raise ValueError(f"not a serving artifact: kind={meta.get('kind')!r}")
    bucket = meta.get("bucket_name")
    if bucket not in BUCKET_FNS:
        raise ValueError(f"artifact bucket fn {bucket!r} unknown to this "
                         f"build; have {sorted(BUCKET_FNS)}")
    table_size = int(meta.get("table_size", 0))
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"table_size must be a positive power of two, "
                         f"got {table_size}")
    m, d = arrays["lsh_w"].shape
    for name in ("lsh_z", "lsh_r1", "lsh_r2"):
        if arrays[name].shape != (m, d):
            raise ValueError(f"{name}: shape {arrays[name].shape} != "
                             f"lsh_w shape {(m, d)}")
    tables = arrays["tables"]
    if tables.ndim not in (2, 3) or tables.shape[:2] != (m, table_size):
        raise ValueError(f"tables: shape {tables.shape} inconsistent with "
                         f"m={m}, table_size={table_size}")
    beta = arrays["beta"]
    if beta.shape[1:] != tables.shape[2:]:
        raise ValueError(f"beta RHS block {beta.shape} vs tables "
                         f"{tables.shape}: column counts differ")
    with obs.span("io.validate_artifact",
                  to_histogram=obs.histogram(
                      "io_artifact_validate_us",
                      "host scan of the tables for non-finite values")):
        finite = bool(np.isfinite(tables).all())
    if not finite:
        bad = int(np.sum(~np.isfinite(tables)))
        raise ValueError(f"tables contain {bad} non-finite entries; a "
                         f"poisoned artifact is rejected at load, not "
                         f"served as silent NaN predictions")
    if meta.get("has_norm"):
        for name in ("x_mean", "x_std", "y_mean", "y_std"):
            if name not in arrays:
                raise ValueError(f"has_norm set but {name} missing")
        if arrays["x_mean"].shape != (d,) or arrays["x_std"].shape != (d,):
            raise ValueError(f"normalization stats shaped "
                             f"{arrays['x_mean'].shape}, expected ({d},)")


def load_artifact(directory: str, *, device=None,
                  artifact_id: str | None = None, retries: int = 0,
                  retry_backoff_s: float = 0.05) -> LoadedArtifact:
    """Load and validate an artifact (from either package) onto ``device``
    (None: the card, raising without one) and rebuild its operator there.
    Raises ``ValueError`` on any shape or metadata inconsistency and on a
    format newer than this build reads.

    ``retries`` retries transient failures only (OSError, a short-read zip
    from a racing writer) with exponential backoff from
    ``retry_backoff_s``; validation failures raise at once."""
    dev = resolve_device(device)
    with obs.span("io.load_artifact",
                  to_histogram=obs.histogram(
                      "io_artifact_load_us",
                      "artifact load wall time (incl. retries)")):
        loaded = _with_retries(lambda: _load_artifact_once(
            directory, dev, artifact_id=artifact_id), retries,
            retry_backoff_s)
        obs.counter("io_artifact_loads_total", "artifacts loaded",
                    labels=("kind",)).labels("single").inc()
        return loaded


def _load_artifact_once(directory: str, dev: torch.device, *,
                        artifact_id: str | None) -> LoadedArtifact:
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no artifact under {directory}")
    if step > ARTIFACT_FORMAT:
        raise ValueError(f"artifact format {step} is newer than this build's "
                         f"reader (supports <= {ARTIFACT_FORMAT})")
    meta = _read_meta(directory, step)
    manifest = meta.get("arrays")
    if not isinstance(manifest, dict) or "lsh_w" not in manifest:
        raise ValueError("artifact meta has no array manifest")
    template = {name: np.zeros(tuple(shape), _DTYPES.get(name, np.float32))
                for name, shape in manifest.items()}
    arrays, _, meta = restore_checkpoint(directory, template, step)
    _validate(meta, arrays)

    def put(name, dtype=np.float32):
        return torch.from_numpy(
            np.ascontiguousarray(arrays[name], dtype)).to(dev)

    lsh = lsh_params_from_numpy(arrays["lsh_w"], arrays["lsh_z"],
                                arrays["lsh_r1"], arrays["lsh_r2"], dev)
    model = WLSHKRRModel(
        lsh=lsh, bucket_name=meta["bucket_name"], beta=put("beta"),
        tables=put("tables"), table_size=int(meta["table_size"]),
        cg_iters=torch.tensor(meta.get("cg_iters", 0), dtype=torch.int32,
                              device=dev),
        cg_resnorm=torch.tensor(meta.get("cg_resnorm", 0.0),
                                dtype=torch.float32, device=dev),
        precond=meta.get("precond", "none"))
    norm = None
    if meta.get("has_norm"):
        norm = Normalization(x_mean=arrays["x_mean"], x_std=arrays["x_std"],
                             y_mean=float(arrays["y_mean"]),
                             y_std=float(arrays["y_std"]))
    return LoadedArtifact(
        artifact_id=artifact_id or meta.get("artifact_id")
        or os.path.basename(os.path.normpath(directory)),
        model=model, operator=model_operator(model), norm=norm, meta=meta)


def _read_meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step}", "meta.json")) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# sharded artifacts: a (model_shards, data_shards) piece grid
# ---------------------------------------------------------------------------
#
# The JAX package's format: piece (i, j) holds model shard i's LSH rows
# (m_loc, d) and its slot range of the tables (m_loc, spp[, k]), spp =
# table_size / data_shards: the layout ``make_krr_step_hashjoin`` leaves the
# table in (data rank j owns slots [j*spp, (j+1)*spp)), so a serving rank
# loads only its own piece.  Every piece is an atomic checkpoint; the
# manifest.json is written LAST, also atomically, and carries an
# ``export_version`` cross-checked against every piece's meta: a torn export
# (pieces, no manifest) is invisible and a mixed one never assembles.

MANIFEST_NAME = "manifest.json"
_LSH_NAMES = ("w", "z", "r1", "r2")


class LoadedShardedArtifact(NamedTuple):
    artifact_id: str
    model: WLSHKRRModel          # reassembled full model (beta dropped)
    operator: WLSHOperator       # on the device the arrays were put on
    norm: Normalization | None
    mesh_shape: tuple[int, int]  # (model_shards, data_shards) of the export
    manifest: dict


class LoadedPiece(NamedTuple):
    """One rank's share of a sharded artifact (``load_artifact_piece``)."""

    artifact_id: str
    manifest: dict
    mesh_shape: tuple[int, int]   # (model_shards, data_shards)
    piece: tuple[int, int]        # (i, j): model shard i, data shard j
    lsh: object                   # LSHParams, my m_loc rows on the device
    table: torch.Tensor | None    # (m_loc, spp[, k]) on the device (None
                                  #   when read without it)
    lsh_host: dict | None         # every model shard's rows, numpy (w, z,
                                  #   r1, r2 of all m), when asked for
    norm: Normalization | None


def piece_name(i: int, j: int) -> str:
    return f"shard_{i}_{j}"


def export_artifact_sharded(directory: str, model: WLSHKRRModel, *,
                            mesh_shape: tuple[int, int],
                            artifact_id: str | None = None,
                            norm: Normalization | None = None,
                            extra_meta: dict | None = None,
                            golden_queries: int = GOLDEN_QUERIES,
                            golden_x=None,
                            golden_tol: float = GOLDEN_TOL) -> str:
    """Atomically export ``model`` as a (model_shards, data_shards) piece
    grid for a sharded serving grid; returns the artifact id.

    Requires ``m % model_shards == 0`` and ``table_size % data_shards ==
    0``.  ``beta`` is dropped (serving never reads it); normalization stats
    and the canary golden set (the FULL model's predictions) travel in the
    manifest.  Pieces are written first, each through the checkpoint
    store's tmp+rename, the manifest last through its own atomic rename,
    with ``export_version`` one past the last published manifest's."""
    mm, nd = int(mesh_shape[0]), int(mesh_shape[1])
    if mm <= 0 or nd <= 0:
        raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
    tables = _host(model.tables).astype(np.float32, copy=False)
    m, table_size = tables.shape[:2]
    if m % mm:
        raise ValueError(f"m={m} not divisible by model_shards={mm}")
    if table_size % nd:
        raise ValueError(f"table_size={table_size} not divisible by "
                         f"data_shards={nd}")
    m_loc, spp = m // mm, table_size // nd
    artifact_id = artifact_id or os.path.basename(os.path.normpath(directory))
    prev = _read_manifest(directory)
    version = int(prev.get("export_version", 0)) + 1 if prev else 1
    with obs.span("io.export_artifact_sharded",
                  to_histogram=obs.histogram(
                      "io_artifact_export_us",
                      "artifact export wall time")):
        arrays_all = _model_arrays(model, include_beta=False)
        lsh = {n: arrays_all[f"lsh_{n}"] for n in _LSH_NAMES}
        common = {"kind": "wlsh_krr_sharded_piece",
                  "format": ARTIFACT_FORMAT,
                  "artifact_id": artifact_id,
                  "export_version": version,
                  "mesh_shape": [mm, nd],
                  "bucket_name": model.bucket_name,
                  "table_size": int(table_size),
                  "m": int(m)}
        pieces = {}
        for i in range(mm):
            for j in range(nd):
                arrays = {f"lsh_{n}": v[i * m_loc:(i + 1) * m_loc]
                          for n, v in lsh.items()}
                arrays["tables"] = np.ascontiguousarray(
                    tables[i * m_loc:(i + 1) * m_loc, j * spp:(j + 1) * spp])
                name = piece_name(i, j)
                save_checkpoint(os.path.join(directory, name),
                                ARTIFACT_FORMAT, arrays,
                                {**common, "piece": [i, j],
                                 "arrays": {k: list(v.shape)
                                            for k, v in arrays.items()}})
                pieces[f"{i},{j}"] = name
        on_card = model.tables.device.type == "cuda"
        manifest = {"kind": "wlsh_krr_sharded_artifact",
                    "format": ARTIFACT_FORMAT,
                    "artifact_id": artifact_id,
                    "export_version": version,
                    "mesh_shape": [mm, nd],
                    "m": int(m), "table_size": int(table_size),
                    "k": int(tables.shape[2]) if tables.ndim == 3 else 0,
                    "bucket_name": model.bucket_name,
                    "backend": "pallas" if on_card else "reference",
                    "framework": "torch",
                    "precond": model.precond,
                    "cg_iters": int(_host(model.cg_iters)),
                    "pieces": pieces,
                    "has_norm": norm is not None,
                    **(extra_meta or {})}
        if golden_queries > 0 or golden_x is not None:
            manifest["golden"] = _golden_block(model, norm, k=golden_queries,
                                               x=golden_x, tol=golden_tol)
        if norm is not None:
            manifest["norm"] = {
                "x_mean": np.asarray(norm.x_mean, np.float32)
                .reshape(-1).tolist(),
                "x_std": np.asarray(norm.x_std, np.float32)
                .reshape(-1).tolist(),
                "y_mean": float(np.float32(norm.y_mean)),
                "y_std": float(np.float32(norm.y_std))}
        _write_manifest(directory, manifest)
    obs.counter("io_artifact_exports_total", "artifacts exported",
                labels=("kind",)).labels("sharded").inc()
    return artifact_id


def _write_manifest(directory: str, manifest: dict) -> None:
    from ..checkpoint import store
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MANIFEST_NAME)
    if store._crash_mid_save is not None:
        # a killed writer (testing.faults) may die before the manifest too:
        # every piece written, the export still unpublished
        store._crash_mid_save(path)
    atomic_write_json(path, manifest)


def _read_manifest(directory: str) -> dict | None:
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def _with_retries(fn, retries: int, backoff_s: float):
    """fn() retried on transient failures (OSError, a short-read zip from a
    racing writer) with exponential backoff; anything else raises."""
    attempt = 0
    while True:
        try:
            return fn()
        except (OSError, zipfile.BadZipFile):
            if attempt >= retries:
                raise
            obs.counter("io_artifact_load_retries_total",
                        "transient artifact-load failures retried").inc()
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def _checked_manifest(directory: str, mesh_shape) -> dict:
    """The manifest, refused when it is not a sharded artifact, newer than
    this build reads, or exported for another grid than ``mesh_shape``."""
    manifest = _read_manifest(directory)
    if manifest is None:
        raise FileNotFoundError(f"no sharded artifact manifest under "
                                f"{directory}")
    if manifest.get("kind") != "wlsh_krr_sharded_artifact":
        raise ValueError(f"not a sharded artifact: "
                         f"kind={manifest.get('kind')!r}")
    fmt = int(manifest.get("format", 0))
    if fmt > ARTIFACT_FORMAT:
        raise ValueError(f"sharded artifact format {fmt} is newer than this "
                         f"build's reader (supports <= {ARTIFACT_FORMAT})")
    rec = tuple(manifest.get("mesh_shape", ()))
    want = (int(mesh_shape[0]), int(mesh_shape[1]))
    if rec != want:
        raise ValueError(
            f"sharded artifact was exported for mesh {rec}, target mesh is "
            f"{want}: piece slot ranges do not line up — re-export for the "
            f"target mesh")
    bucket = manifest.get("bucket_name")
    if bucket not in BUCKET_FNS:
        raise ValueError(f"artifact bucket fn {bucket!r} unknown to this "
                         f"build; have {sorted(BUCKET_FNS)}")
    return manifest


def _piece_meta(directory: str, manifest: dict, i: int, j: int):
    """(piece dir, step, meta) of piece (i, j), cross-checked against the
    manifest: a torn piece (no complete checkpoint) raises
    FileNotFoundError, one of another export generation or grid
    ValueError."""
    name = manifest["pieces"].get(f"{i},{j}")
    if name is None:
        raise ValueError(f"manifest missing piece ({i},{j})")
    pdir = os.path.join(directory, name)
    step = latest_step(pdir)
    if step is None:
        raise FileNotFoundError(
            f"sharded artifact piece ({i},{j}) has no complete checkpoint "
            f"under {pdir} (torn export?)")
    meta = _read_meta(pdir, step)
    version = int(manifest.get("export_version", 1))
    grid = list(manifest["mesh_shape"])
    if (meta.get("kind") != "wlsh_krr_sharded_piece"
            or meta.get("piece") != [i, j]
            or int(meta.get("export_version", -1)) != version
            or list(meta.get("mesh_shape", ())) != grid):
        raise ValueError(
            f"piece ({i},{j}) meta disagrees with the manifest (version "
            f"{meta.get('export_version')} vs {version}, mesh "
            f"{meta.get('mesh_shape')} vs {grid}) — mixed or torn export")
    return pdir, step, meta


def _read_piece(directory: str, manifest: dict, i: int, j: int,
                *, lsh_only: bool = False) -> dict[str, np.ndarray]:
    """Piece (i, j)'s arrays, validated: shapes against the manifest, the
    tables for non-finite entries.  ``lsh_only`` reads the LSH rows and
    leaves the tables on disk."""
    mm, nd = manifest["mesh_shape"]
    m, table_size = int(manifest["m"]), int(manifest["table_size"])
    k = int(manifest.get("k", 0))
    m_loc, spp = m // mm, table_size // nd
    pdir, step, meta = _piece_meta(directory, manifest, i, j)
    d = int(meta["arrays"]["lsh_w"][1])
    shapes = {f"lsh_{n}": (m_loc, d) for n in _LSH_NAMES}
    shapes["tables"] = (m_loc, spp) + ((k,) if k else ())
    names = [f"lsh_{n}" for n in _LSH_NAMES] + ([] if lsh_only
                                                else ["tables"])
    path = os.path.join(pdir, f"step_{step}", "arrays.npz")
    with np.load(path) as npz:
        arrays = {n: npz[f"[{n!r}]"] for n in names}
    for n in names:
        if arrays[n].shape != shapes[n]:
            raise ValueError(f"piece ({i},{j}) {n}: shape {arrays[n].shape}"
                             f" != {shapes[n]} from the manifest")
        arrays[n] = np.ascontiguousarray(arrays[n], _DTYPES[n])
    if not lsh_only and not np.isfinite(arrays["tables"]).all():
        raise ValueError(f"piece ({i},{j}) tables contain non-finite "
                         f"entries — poisoned piece rejected at load")
    return arrays


def _manifest_norm(manifest: dict) -> Normalization | None:
    if not manifest.get("has_norm"):
        return None
    nm = manifest["norm"]
    return Normalization(x_mean=np.asarray(nm["x_mean"], np.float32),
                         x_std=np.asarray(nm["x_std"], np.float32),
                         y_mean=float(nm["y_mean"]),
                         y_std=float(nm["y_std"]))


def _artifact_id(directory, manifest, artifact_id):
    return (artifact_id or manifest.get("artifact_id")
            or os.path.basename(os.path.normpath(directory)))


def load_artifact_sharded(directory: str, *, mesh_shape: tuple[int, int],
                          device=None, artifact_id: str | None = None,
                          retries: int = 0, retry_backoff_s: float = 0.05
                          ) -> LoadedShardedArtifact:
    """Load and validate a whole sharded artifact for a TARGET grid and
    reassemble the model on ``device`` (None: the card).

    A manifest recording another grid than ``mesh_shape`` is refused (the
    pieces' slot ranges are baked into the export: re-export for the
    target grid).  Every piece's meta is cross-checked against the manifest
    (format, export version, geometry): a piece whose save was killed is
    invisible to ``latest_step`` and surfaces as a missing piece, one of
    another export generation fails the version check, and non-finite
    tables are refused.  ``retries`` retries transient failures (a missing
    manifest or piece while a publisher writes, a short-read zip) with
    exponential backoff; validation failures raise at once."""
    dev = resolve_device(device)

    def once():
        manifest = _checked_manifest(directory, mesh_shape)
        mm, nd = manifest["mesh_shape"]
        lsh_rows, table_rows = [], []
        for i in range(mm):
            row = [_read_piece(directory, manifest, i, j) for j in range(nd)]
            lsh_rows.append(row[0])
            table_rows.append(np.concatenate([p["tables"] for p in row], 1))
        lsh = lsh_params_from_numpy(
            *(np.concatenate([r[f"lsh_{n}"] for r in lsh_rows])
              for n in _LSH_NAMES), dev)
        k = int(manifest.get("k", 0))
        model = WLSHKRRModel(
            lsh=lsh, bucket_name=manifest["bucket_name"],
            beta=torch.zeros((0, k) if k else (0,), dtype=torch.float32,
                             device=dev),
            tables=torch.from_numpy(np.concatenate(table_rows)).to(dev),
            table_size=int(manifest["table_size"]),
            cg_iters=torch.tensor(manifest.get("cg_iters", 0),
                                  dtype=torch.int32, device=dev),
            cg_resnorm=torch.tensor(0.0, dtype=torch.float32, device=dev),
            precond=manifest.get("precond", "none"))
        return LoadedShardedArtifact(
            artifact_id=_artifact_id(directory, manifest, artifact_id),
            model=model, operator=model_operator(model),
            norm=_manifest_norm(manifest), mesh_shape=(mm, nd),
            manifest=manifest)

    with obs.span("io.load_artifact_sharded",
                  to_histogram=obs.histogram(
                      "io_artifact_load_us",
                      "artifact load wall time (incl. retries)")):
        loaded = _with_retries(once, retries, retry_backoff_s)
    obs.counter("io_artifact_loads_total", "artifacts loaded",
                labels=("kind",)).labels("sharded").inc()
    return loaded


def load_artifact_piece(directory: str, *, mesh_shape: tuple[int, int],
                        piece: tuple[int, int], device=None,
                        artifact_id: str | None = None,
                        with_table: bool = True,
                        with_lsh_host: bool = False, retries: int = 0,
                        retry_backoff_s: float = 0.05) -> LoadedPiece:
    """One rank's share of a sharded artifact: the manifest and piece
    ``(i, j)`` only (the SPMD serving grid: each rank loads its own piece),
    validated as ``load_artifact_sharded`` validates every piece, onto
    ``device`` (None: the card).  ``with_lsh_host`` also reads every model
    shard's LSH rows (from pieces (i', 0), tables left on disk), version
    checked the same way: the front end's cache keys need all m
    instances.  ``with_table=False`` leaves the piece's table on disk (a
    front end outside the model's placement).  Same retry contract as
    ``load_artifact_sharded``."""
    dev = resolve_device(device)
    i, j = int(piece[0]), int(piece[1])

    def once():
        manifest = _checked_manifest(directory, mesh_shape)
        mm, nd = manifest["mesh_shape"]
        if not (0 <= i < mm and 0 <= j < nd):
            raise ValueError(f"piece {(i, j)} outside the {mm}x{nd} grid")
        arrays = _read_piece(directory, manifest, i, j,
                             lsh_only=not with_table)
        lsh_host = None
        if with_lsh_host:
            rows = [arrays if ii == i else
                    _read_piece(directory, manifest, ii, 0, lsh_only=True)
                    for ii in range(mm)]
            lsh_host = {n: np.concatenate([r[f"lsh_{n}"] for r in rows])
                        for n in _LSH_NAMES}
        return LoadedPiece(
            artifact_id=_artifact_id(directory, manifest, artifact_id),
            manifest=manifest, mesh_shape=(mm, nd), piece=(i, j),
            lsh=lsh_params_from_numpy(*(arrays[f"lsh_{n}"]
                                        for n in _LSH_NAMES), dev),
            table=(torch.from_numpy(arrays["tables"]).to(dev)
                   if with_table else None),
            lsh_host=lsh_host, norm=_manifest_norm(manifest))

    with obs.span("io.load_artifact_piece",
                  to_histogram=obs.histogram(
                      "io_artifact_load_us",
                      "artifact load wall time (incl. retries)")):
        loaded = _with_retries(once, retries, retry_backoff_s)
    obs.counter("io_artifact_loads_total", "artifacts loaded",
                labels=("kind",)).labels("piece").inc()
    return loaded
