"""Checkpointing: atomic on-disk snapshots with asynchronous writes and
latest-complete discovery, in the JAX package's on-disk format.

Layout:  <dir>/step_<n>/arrays.npz + meta.json, written to step_<n>.tmp and
atomically renamed: a crash mid-write never leaves a half checkpoint that
``restore_checkpoint`` would pick up.  Arrays are stored on the host,
unsharded; ``restore_resharded`` hands each rank of a (model, data) grid
its slice of each leaf.

The npz keys are the JAX package's ``jax.tree_util.keystr`` paths, written
here without JAX: a dict entry is ``['name']`` (keys in sorted order), a
NamedTuple field ``.field`` and a list or tuple item ``[i]``, nested by
concatenation; ``None`` holds no leaf.  So a checkpoint written by either
package restores in the other.  Tensors are copied to the host; a Python
number is stored as a 0-d array.

Asynchronous mode copies the state to host memory on the calling thread
and runs the file write on a worker thread.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import struct
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from .. import obs
from ..sharding import local_block, spec_axis

_STEP_RE = re.compile(r"^step_(\d+)$")

# Test-injection point (repro_torch.testing.faults.killed_checkpoint_writer):
# when set, called with the tmp path after arrays.npz is written but before
# the atomic rename; raising there leaves the tmp dir exactly as a killed
# writer would: full payload, invisible to latest_step, swept later by
# CheckpointManager._gc.
_crash_mid_save = None


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _walk(tree: Any, path: str):
    """(keystr path, leaf) pairs of ``tree`` in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, tree


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """{keystr path: host array} of every leaf of ``tree``."""
    return {key: _leaf(leaf) for key, leaf in _walk(tree, "")}


def _unflatten(template: Any, arrays: dict[str, np.ndarray],
               path: str = "") -> Any:
    """``template``'s structure with each leaf replaced by ``arrays`` at its
    keystr path; the shapes must match the template's leaves."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], arrays, f"{path}[{k!r}]")
                for k in template}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(getattr(template, name), arrays, f"{path}.{name}")
            for name in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, arrays, f"{path}[{i}]")
                              for i, v in enumerate(template))
    if path not in arrays:
        raise KeyError(f"checkpoint missing array for {path}")
    arr = arrays[path]
    want = tuple(template.shape) if hasattr(template, "shape") else ()
    if tuple(arr.shape) != want:
        raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                         f"expected {want}")
    return arr


def save_checkpoint(directory: str, step: int, state: Any,
                    meta: dict | None = None) -> str:
    """Blocking atomic save.  Returns the final checkpoint path."""
    with obs.span("io.checkpoint_save", {"step": step},
                  to_histogram=obs.histogram(
                      "io_checkpoint_save_us",
                      "blocking checkpoint save wall time")):
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        if _crash_mid_save is not None:
            _crash_mid_save(tmp)
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"step": step, **(meta or {})}, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        obs.counter("io_checkpoint_saves_total",
                    "checkpoints written to disk").inc()
        obs.counter("io_checkpoint_bytes_total",
                    "uncompressed array bytes written to checkpoints"
                    ).inc(sum(v.nbytes for v in flat.values()))
        return final


def atomic_write_json(path: str, obj: dict) -> None:
    """Write ``obj`` to ``path`` via a temp file and ``os.replace``: readers
    see the previous complete document or the new one, never a torn
    write."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def latest_step(directory: str) -> int | None:
    """Largest step with a COMPLETE checkpoint (tmp dirs are ignored)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Any, step: int | None = None):
    """Returns (state, step, meta); the state's leaves are numpy arrays
    (the caller moves them to its device)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    with obs.span("io.checkpoint_restore", {"step": step},
                  to_histogram=obs.histogram(
                      "io_checkpoint_restore_us",
                      "checkpoint restore wall time")):
        path = os.path.join(directory, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        obs.counter("io_checkpoint_restores_total",
                    "checkpoints restored from disk").inc()
        return _unflatten(template, arrays), step, meta


def restore_like(directory: str, template: Any, step: int | None = None):
    """``restore_checkpoint`` with each leaf a new tensor on its template
    leaf's device and dtype (a leaf whose template is not a tensor stays a
    numpy array).  Returns (state, step, meta)."""
    state, step, meta = restore_checkpoint(directory, template, step)
    want = dict(_walk(template, ""))

    def place(path, arr):
        t = want[path]
        if not isinstance(t, torch.Tensor):
            return arr
        return torch.from_numpy(np.array(arr)).to(device=t.device,
                                                  dtype=t.dtype)

    return _map_leaves(state, place), step, meta


PLACEMENT_AXES = ("model", "data")


class _Members:
    """The arrays of an ``arrays.npz``, read one at a time: a member stored
    without compression (``np.savez``'s) is memory-mapped, so a rank's
    block of it reads only that block's pages; a compressed one is read
    whole."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path)
        self.files = {n[:-4] for n in self._zip.namelist()
                      if n.endswith(".npy")}

    _HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        header = None
        if info.compress_type == zipfile.ZIP_STORED:
            with open(self.path, "rb") as fh:
                fh.seek(info.header_offset)
                head = fh.read(30)              # the local file header
                if head[:4] != b"PK\x03\x04":
                    raise ValueError(f"{self.path}: {key} has no local "
                                     f"file header")
                name_len, extra_len = struct.unpack("<HH", head[26:30])
                fh.seek(info.header_offset + 30 + name_len + extra_len)
                read = self._HEADERS.get(np.lib.format.read_magic(fh))
                if read is not None:
                    header = read(fh) + (fh.tell(),)
        if header is None or header[2].hasobject or math.prod(
                header[0]) <= 1:
            with self._zip.open(info) as fh:
                return np.lib.format.read_array(fh)
        shape, fortran, dtype, offset = header
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order="F" if fortran else "C")

    def close(self) -> None:
        self._zip.close()


def _map_leaves(tree: Any, fn, path: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by fn(keystr path,
    leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(getattr(tree, name), fn,
                                        f"{path}.{name}")
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def restore_resharded(directory: str, template: Any, placement: dict,
                      mesh, step: int | None = None):
    """Elastic restore onto this rank of a (model, data) grid: every leaf
    comes back as this rank's block of it, on ``mesh.device``, whatever
    grid (or single host) wrote the checkpoint.  ``placement`` maps a
    leaf's keystr path (``"['tables']"``, ``".lsh.w"``) to its spec, one
    entry per dimension from the first (fewer entries leave the trailing
    dimensions whole): ``"model"`` (cut into ``mesh.model`` parts, mine at
    ``mesh.model_rank``), ``"data"`` or a tuple of the data axes such as
    ``("pod", "data")`` (the linear data axis: ``mesh.data`` parts at
    ``mesh.data_rank``), or None; a leaf it does not name is replicated.
    So the spec trees of ``launch.specs`` (``param_shardings``, flattened
    by path) place an LM's leaves.  The JAX package places leaves by JAX
    shardings; this is the same cut, taken by each rank for itself.  The
    leaves are read one at a time, each memory-mapped from the file, so a
    rank reads its blocks' pages and the host holds one block at once.
    Returns (state, step, meta) with tensor leaves."""
    paths = {p for p, _ in _walk(template, "")}
    unknown = sorted(set(placement) - paths)
    if unknown:
        raise KeyError(f"placement names no leaf of the template: {unknown}")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)

    def place(leaf, arr):
        spec = tuple(placement.get(leaf) or ())
        if len(spec) > arr.ndim:
            raise ValueError(f"{leaf}: spec {spec} has more entries than "
                             f"its {arr.ndim} dimensions")
        for axis in spec:
            try:
                if axis is not None:
                    spec_axis(axis)
            except ValueError:
                raise ValueError(f"{leaf}: unknown axis {axis!r}; expected "
                                 f"one of {PLACEMENT_AXES}, the data axes "
                                 f"('pod', 'data') or None") from None
        try:
            block = local_block(arr, spec, mesh)
        except ValueError as e:
            raise ValueError(f"{leaf}: {e}") from None
        # a copy: the block is read out of the file's map here
        return torch.from_numpy(np.array(block, order="C")).to(mesh.device)

    with obs.span("io.checkpoint_restore", {"step": step},
                  to_histogram=obs.histogram(
                      "io_checkpoint_restore_us",
                      "checkpoint restore wall time")):
        npz = _Members(os.path.join(path, "arrays.npz"))
        try:
            # _unflatten checks the leaf's shape (a missing one raises)
            state = _map_leaves(template, lambda leaf, t: place(
                leaf, _unflatten(t, {leaf: npz[leaf]} if leaf in npz.files
                                 else {}, leaf)))
        finally:
            npz.close()
        obs.counter("io_checkpoint_restores_total",
                    "checkpoints restored from disk").inc()
    return state, step, meta


class CheckpointManager:
    """Asynchronous checkpointing with bounded retention.

    ``save`` copies the state to the host and hands the file write to a
    worker thread; ``wait``/``flush`` joins the write in flight and
    re-raises any exception it hit.  Keeps the newest ``keep`` checkpoints
    and sweeps stale ``.tmp`` dirs left behind by a killed writer.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, meta: dict | None = None,
             blocking: bool = False) -> None:
        # device -> host now, the tree's structure kept
        host_state = _unflatten(state, _flatten(state))
        self.wait()

        def _write():
            try:
                save_checkpoint(self.directory, step, host_state, meta)
                self._gc()
            except BaseException as e:      # surfaced by the next wait()
                self._error = e

        if blocking:
            _write()
            self.wait()                     # raise at once when blocking
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise its exception, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    flush = wait

    # a .tmp dir this old cannot be a write in flight; younger ones are left
    # alone in case another writer shares the directory
    STALE_TMP_SECONDS = 600.0

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        now = time.time()
        for name in os.listdir(self.directory):
            if not (name.endswith(".tmp") and _STEP_RE.match(name[:-4])):
                continue
            path = os.path.join(self.directory, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue          # raced with its writer's rename
            if age > self.STALE_TMP_SECONDS:
                shutil.rmtree(path, ignore_errors=True)
        steps = sorted(s for s in (
            int(m.group(1)) for m in (_STEP_RE.match(n) for n in
                                      os.listdir(self.directory)) if m))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
