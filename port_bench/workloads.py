"""What a run drives: the program under test, and what every kind of
traffic shares.

``PortProgram`` is the system under test: ``repro_torch``'s
``wlsh_krr_fit`` and ``wlsh_krr_predict``, looked up at each call.
``ControlProgram`` puts the reference in its place in bfloat16, the
control that the comparison must refuse.

A mix's ``kind`` names its runner, ``kinds/<kind>.py``, whose ``Runner``
(a ``Traffic``) has ``setup()``, ``window(seconds)`` and, once the
window has closed, ``release()`` (the program's state goes) and
``check(limits)`` (the reference judges what the window produced).
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from . import generate
from . import reference as ref


def sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class PortProgram:
    """repro_torch's WLSH-KRR entry points on ``device``."""

    def __init__(self, cfg: dict, inputs: generate.Inputs, device):
        from repro_torch.core import lsh as L
        from repro_torch.core.bucket_fns import get_bucket_fn
        from repro_torch.core.kernels import WLSHKernelSpec
        self.cfg, self.device = cfg, device
        p = inputs.lsh
        self.lsh = L.lsh_params_from_numpy(p["w"], p["z"], p["r1"], p["r2"],
                                           device)
        self.spec = WLSHKernelSpec(
            bucket=get_bucket_fn(cfg["bucket"]),
            pdf=L.GammaPDF(cfg["pdf"]["shape"], cfg["pdf"]["scale"]),
            lengthscale=inputs.lengthscale)

    @staticmethod
    def build(device) -> dict:
        """Compiles the libraries of the fit and predict path that this
        checkout has not built yet: {library: nvcc seconds}, empty in every
        run but a checkout's first (whose ``setup_s`` holds them)."""
        if device.type != "cuda":
            return {}
        from repro_torch.kernels import _build
        return _build.build_all(("featurize", "binning"))

    def fit(self, x, y):
        from repro_torch.core import krr
        c = self.cfg
        return krr.wlsh_krr_fit(self.lsh, x, y, self.spec, lam=c["lam"],
                                table_size=c["table_size"], tol=c["tol"],
                                atol=c["atol"], maxiter=c["maxiter"],
                                device=self.device)

    def predict(self, model, xq, batch_size: int):
        from repro_torch.core import krr
        return krr.wlsh_krr_predict(model, xq, batch_size=batch_size)

    @staticmethod
    def launch_counts() -> dict:
        from repro_torch.kernels import launch_counts
        return launch_counts()


class RefModel(NamedTuple):
    beta: torch.Tensor
    tables: torch.Tensor
    telemetry: dict


class ControlProgram:
    """The reference in the program's place, every value of the solve and
    the readout held in bfloat16 (the precision below the
    configuration's float32)."""

    dtype = torch.bfloat16

    def __init__(self, cfg: dict, inputs: generate.Inputs, device):
        self.cfg, self.device = cfg, device
        self.lsh = generate.reference_lsh(inputs.lsh, device)

    @staticmethod
    def build(device) -> dict:
        return {}

    def fit(self, x, y):
        t0 = sync(self.device)
        beta, tables, it = ref.fit(x, y, self.lsh, self.cfg,
                                   dtype=self.dtype)
        tel = {"iters": it, "phase_seconds": {
            "featurize": 0.0, "layout": 0.0,
            "pcg": sync(self.device) - t0, "tables": 0.0}}
        return RefModel(beta, tables, tel)

    def predict(self, model, xq, batch_size: int):
        return torch.cat([ref.predict(xq[i:i + batch_size], self.lsh,
                                      self.cfg, model.tables)
                          for i in range(0, xq.shape[0], batch_size)])

    @staticmethod
    def launch_counts() -> dict:
        return {}


PROGRAMS = {"port": PortProgram, "control": ControlProgram}


def telemetry(model) -> dict:
    tel = model.telemetry
    return {"iters": int(tel["iters"]),
            "phase_seconds": dict(tel["phase_seconds"])}


class Traffic:
    """Shared by both kinds: the inputs, the program, the counters."""

    def __init__(self, cfg, traffic, inputs, program, device, seed):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.program, self.device, self.seed = program, device, seed
        self.attempted = self.failed = 0
        self.fits: list[dict] = []        # telemetry of the window's fits
        self.rows = 0                     # query rows answered
        self.errors: list[str] = []

    def _attempt(self, fn, *args):
        self.attempted += 1
        try:
            return fn(*args)
        except Exception as exc:          # an answer that never comes
            self.failed += 1
            if len(self.errors) < 3:
                self.errors.append(f"{type(exc).__name__}: {exc}")
            return None


def passed(checks: dict) -> bool:
    """Every compared number finite and within its limit; a count of
    answers judged (``*_checked``) must reach its limit."""
    ok = True
    for name, c in checks.items():
        v = float(c["value"])
        if name.endswith("_checked"):
            ok &= v >= c["limit"]
        else:
            ok &= math.isfinite(v) and v <= c["limit"]
    return bool(ok)
