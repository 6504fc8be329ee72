"""The port's spans inside the solve and predict paths (``repro_torch.obs``
on the CPU): how many samples a fit and a predict add to each name, that
every span and timer is a region of the profiler's capture whoever started
it, and that with tracing off nothing is recorded and the fit is bitwise
the traced one."""
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import core as T
from repro_torch import obs

FIT_SPANS = ("fit.featurize", "fit.layout", "fit.pcg", "fit.tables")
NAMES = FIT_SPANS + ("pcg.issue", "pcg.wait", "op.matvec", "predict",
                     "predict.block")
MAXITER = 7


def _problem(seed=3, n=200, d=3, m=8):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(), device="cpu")
    return x, y, lsh, rng


def _fit(x, y, lsh):
    """A fit that runs to ``MAXITER`` (tol and atol 0 are never met)."""
    return T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT),
                          lam=0.5, tol=0.0, atol=0.0, maxiter=MAXITER,
                          device="cpu")


def _counts():
    return {n: len(obs.span_samples_us(n)) for n in NAMES}


@pytest.fixture
def cleared():
    for name in NAMES:
        obs.clear_span_samples(name)
    prev = obs.set_tracing(True)
    yield
    obs.set_tracing(prev)


def test_fit_records_each_iteration_and_phase(cleared):
    x, y, lsh, _ = _problem()
    model = _fit(x, y, lsh)
    iters = model.telemetry["iters"]
    assert iters == MAXITER
    assert _counts() == {
        "pcg.issue": iters, "pcg.wait": iters,
        "op.matvec": iters + 1,          # the initial residual's is one
        **{name: 1 for name in FIT_SPANS}, "predict": 0, "predict.block": 0}
    seconds = model.telemetry["phase_seconds"]
    assert list(seconds) == ["featurize", "layout", "pcg", "tables"]
    for key, value in seconds.items():
        assert value == obs.span_samples_us(f"fit.{key}")[0] * 1e-6
    # the solve's iterations lie inside its span
    pcg_us = obs.span_samples_us("fit.pcg")[0]
    assert sum(obs.span_samples_us("pcg.issue")) + \
        sum(obs.span_samples_us("pcg.wait")) < pcg_us


@pytest.mark.parametrize("rows,batch", [(50, 16), (48, 16), (50, None),
                                        (50, 50), (50, 64), (1, 1)])
def test_predict_records_the_call_and_each_block(cleared, rows, batch):
    x, y, lsh, rng = _problem()
    model = _fit(x, y, lsh)
    for name in NAMES:
        obs.clear_span_samples(name)
    xq = rng.random((rows, x.shape[1]), dtype=np.float32)
    out = T.wlsh_krr_predict(model, xq, batch_size=batch)
    assert out.shape == (rows,)
    blocks = 1 if batch is None else math.ceil(rows / batch)
    assert _counts()["predict"] == 1
    assert _counts()["predict.block"] == blocks
    assert sum(obs.span_samples_us("predict.block")) <= \
        obs.span_samples_us("predict")[0]


def test_spans_are_regions_of_any_capture(cleared):
    """A plain ``torch.profiler.profile``, with no ``start_trace``, holds
    every span and timer of a fit and a predict under its name."""
    x, y, lsh, rng = _problem()
    assert obs.tracing._capture() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.tracing._capture() is not None
        model = _fit(x, y, lsh)
        T.wlsh_krr_predict(model, x[:40], batch_size=16)
    assert obs.tracing._capture() is None
    seen = {}
    for e in prof.profiler.kineto_results.events():
        seen[e.name()] = seen.get(e.name(), 0) + 1
    assert {n: seen.get(n, 0) for n in NAMES} == {
        "pcg.issue": MAXITER, "pcg.wait": MAXITER, "op.matvec": MAXITER + 1,
        **{name: 1 for name in FIT_SPANS}, "predict": 1, "predict.block": 3}
    # the regions nest as the code does: each iteration inside the solve's
    ev = {n: sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == n) for n in ("fit.pcg", "pcg.issue")}
    (a, b), = ev["fit.pcg"]
    assert all(a <= s and e <= b for s, e in ev["pcg.issue"])


def test_tracing_off_records_nothing_and_fits_the_same(cleared):
    x, y, lsh, _ = _problem(seed=5)
    traced = _fit(x, y, lsh)
    for name in NAMES:
        obs.clear_span_samples(name)
    obs.set_tracing(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model = _fit(x, y, lsh)
        T.wlsh_krr_predict(model, x[:40], batch_size=16)
    assert _counts() == {name: 0 for name in NAMES}
    assert not {e.name() for e in prof.profiler.kineto_results.events()} & \
        set(NAMES)
    assert model.telemetry["phase_seconds"] == {}
    assert model.telemetry["iters"] == traced.telemetry["iters"]
    assert torch.equal(model.beta, traced.beta)
    assert torch.equal(model.tables, traced.tables)


def test_start_trace_writes_the_spans_and_annotation_names_are_gone(
        cleared, tmp_path):
    assert not hasattr(obs, "annotation")
    assert not hasattr(obs, "set_annotations")
    assert {"annotation", "set_annotations"}.isdisjoint(obs.__all__)
    x, y, lsh, _ = _problem()
    assert obs.start_trace(str(tmp_path))
    try:
        _fit(x, y, lsh)
    finally:
        out = obs.stop_trace()
    assert out == str(tmp_path)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"fit.pcg", "pcg.issue", "pcg.wait", "op.matvec"} <= names
