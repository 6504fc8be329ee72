"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Builds happen at first use, never at import, into
``_build/`` beside the package (listed in ``.gitignore``); a library's file
name carries a hash of its source and flags, so an edited source rebuilds.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0.  Nothing here falls back to the plain
path: a missing compiler, a failed build or a refused launch raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# every library the port builds; scatter_variants holds the first designs
# of B5, B7, B2 and B8, timed beside them and run on no path
SOURCES = ("featurize", "binning", "route", "flash_decode",
           "scatter_variants")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()      # counters bumped from serving threads
_capturing = threading.local()      # the open record of captured_launches


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all at
    once.  Returns {name: seconds} for the ones compiled; the compiler's
    report (registers, shared memory, spills) lands in ``<lib>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    times, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str, error_string) -> None:
    """Raise when a C entry point reported a CUDA error; ``error_string``
    is the library's wrapper of ``cudaGetErrorString``."""
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA launch of {what} failed: {msg} ({rc})")


def count_launch(fn, shape: tuple) -> None:
    """Count one launch of the kernel behind wrapper ``fn``: in
    ``fn.launches`` and, under the shape of its inputs, in
    ``fn.launches_by_shape``.

    A launch made while the current stream captures a CUDA graph runs
    nothing yet: it goes to the record of ``captured_launches`` instead,
    and whoever replays the graph credits that record at each replay
    (``credit_launches``).  A capture with no record open raises, since
    its replays would go uncounted."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_capturing, "record", None)
        if record is None:
            raise RuntimeError(
                f"{fn.__name__} launched into a CUDA graph outside "
                f"captured_launches(): its replays would go uncounted")
        record.append((fn, shape))
        return
    credit_launches(((fn, shape),))


@contextlib.contextmanager
def captured_launches():
    """Open a record of the launches this thread makes into a CUDA graph
    it captures; yields the list of (wrapper, input shape) it fills."""
    record, outer = [], getattr(_capturing, "record", None)
    _capturing.record = record
    try:
        yield record
    finally:
        _capturing.record = outer


def credit_launches(record) -> None:
    """Count each (wrapper, input shape) of ``record`` as one launch."""
    with _count_lock:
        for fn, shape in record:
            fn.launches += 1
            fn.launches_by_shape[shape] = \
                fn.launches_by_shape.get(shape, 0) + 1


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
