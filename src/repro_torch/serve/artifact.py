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
from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
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
    attempt = 0
    with obs.span("io.load_artifact",
                  to_histogram=obs.histogram(
                      "io_artifact_load_us",
                      "artifact load wall time (incl. retries)")):
        while True:
            try:
                loaded = _load_artifact_once(directory, dev,
                                             artifact_id=artifact_id)
                obs.counter("io_artifact_loads_total", "artifacts loaded",
                            labels=("kind",)).labels("single").inc()
                return loaded
            except (OSError, zipfile.BadZipFile):
                if attempt >= retries:
                    raise
                obs.counter("io_artifact_load_retries_total",
                            "transient artifact-load failures retried").inc()
                time.sleep(retry_backoff_s * (2 ** attempt))
                attempt += 1


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
