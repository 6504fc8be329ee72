"""The port's self-healing serving runtime on the CPU: version discovery,
golden canary, atomic swap and rollback, probation, worker supervision and
circuit breakers, with the JAX package's own test cases (its sharded cases
run on gloo grids in tests/test_torch_serving_sharded.py).

Exactness pins:
* a torn publish (killed writer) is INVISIBLE to the watcher;
* a version poisoned on disk after export is canary-rejected with no
  disturbance to the serving version, and never retried;
* a concurrent predict during a swap sees exactly the old or the new
  version's output, bit for bit, never a mix;
* a worker crash is not terminal: the breaker opens, a half-open probe on
  a restarted worker re-closes it; a crash during the probe re-opens it.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch import core as T
from repro_torch.errors import (CircuitOpen, FaultInjected, ServingError,
                                WorkerCrashed)
from repro_torch.serve import (CircuitBreaker, LifecycleConfig,
                               ServingRuntime, SupervisedBatcher,
                               export_artifact, version_dir)
from repro_torch.serve.lifecycle import discover_versions
from repro_torch.testing.faults import (FaultPlan, canary_poison,
                                        crash_supervised_workers,
                                        poison_artifact_tables, torn_publish)


def _fit(seed, n=128, d=4, m=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT),
                           lam=0.5, maxiter=50, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def fitted():
    return _fit(0)


@pytest.fixture(scope="module")
def fitted_b():
    # a different model: the xor pin needs two versions whose outputs differ
    return _fit(7)


def _runtime(root, **over):
    cfg_kw = dict(probation_s=30.0, probation_min_requests=5,
                  probation_max_error_rate=0.2, retain=2,
                  warm_sizes=(8,))
    cfg_kw.update({k: over.pop(k) for k in list(over)
                   if k in LifecycleConfig._fields})
    return ServingRuntime(str(root), device="cpu", max_batch=8,
                          config=LifecycleConfig(**cfg_kw), **over)


def test_sharded_runtime_raises(tmp_path, fitted):
    """A sharded runtime raises where its grid cannot exist (a 1x2 grid on
    a process group of one rank), and a sharded version without its
    manifest (written last) is not published."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            ServingRuntime(str(tmp_path), device="cpu", mesh_shape=(1, 2))
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    model, _ = fitted
    root = tmp_path / "versions"
    torn_publish(version_dir(str(root), 1), model, mesh_shape=(1, 2),
                 after_saves=2)
    assert discover_versions(str(root)) == []
    assert discover_versions(str(root), sharded=True) == []


def test_swap_releases_the_evicted_version(tmp_path, fitted):
    """With retain=1, the version pushed out of the rollback window is
    unloaded: the predictor hosts only the active and the retained one."""
    model, _ = fitted
    rt = _runtime(tmp_path, retain=1, probation_s=0.0)
    for v in (1, 2, 3):
        export_artifact(version_dir(str(tmp_path), v), model)
        rt.poll_once()
    assert rt.predictor.artifact_ids == ["v2", "v3"]
    assert rt.health()["retained_versions"] == [2]


# ---------------------------------------------------------------------------
# version discovery
# ---------------------------------------------------------------------------

def test_discover_versions_flat(tmp_path, fitted):
    model, _ = fitted
    root = tmp_path / "vers"
    assert discover_versions(str(root)) == []          # no root yet
    root.mkdir()
    (root / "scratch").mkdir()                         # non-version noise
    (root / "v9").mkdir()                              # empty: not published
    export_artifact(version_dir(str(root), 2), model)
    export_artifact(version_dir(str(root), 10), model)
    got = discover_versions(str(root))
    assert [v for v, _ in got] == [2, 10]              # sorted, noise ignored


def test_torn_publish_invisible(tmp_path, fitted):
    model, _ = fitted
    root = tmp_path / "vers"
    export_artifact(version_dir(str(root), 1), model)
    torn_publish(version_dir(str(root), 2), model)     # killed mid-write
    assert [v for v, _ in discover_versions(str(root))] == [1]
    rt = _runtime(root)
    assert rt.poll_once()["action"] == "swap"
    assert rt.poll_once()["action"] == "none"          # torn v2 never adopted
    assert rt.active_version == 1


# ---------------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------------

def test_breaker_opens_and_recovers():
    t = [0.0]
    br = CircuitBreaker(name="t1", failure_threshold=2, cooldown_s=1.0,
                        clock=lambda: t[0])
    br.admit()
    br.record_failure()
    br.admit()                                 # 1 failure: still closed
    br.record_failure()
    assert br.state == "open"
    with pytest.raises(CircuitOpen) as ei:
        br.admit()
    assert 0.0 < ei.value.retry_after_s <= 1.0
    t[0] = 1.5                                 # past the cooldown
    br.admit()                                 # the half-open probe
    assert br.state == "half_open"
    br.record_success()
    assert br.state == "closed"
    assert br.stats()["rejected"] == 1


def test_breaker_probe_failure_reopens():
    t = [0.0]
    br = CircuitBreaker(name="t2", failure_threshold=1, cooldown_s=1.0,
                        clock=lambda: t[0])
    br.record_failure()
    t[0] = 2.0
    br.admit()
    br.record_failure()                        # the probe itself failed
    assert br.state == "open"
    with pytest.raises(CircuitOpen):
        br.admit()                             # cooldown restarted at t=2


def test_breaker_neutral_releases_probe_slot():
    t = [0.0]
    br = CircuitBreaker(name="t3", failure_threshold=1, cooldown_s=1.0,
                        half_open_probes=1, clock=lambda: t[0])
    br.record_failure()
    t[0] = 1.5
    br.admit()                                 # probe slot taken
    with pytest.raises(CircuitOpen):
        br.admit()                             # quota exhausted
    br.record_neutral()                        # probe died of shed/deadline
    br.admit()                                 # slot is back — no deadlock
    br.record_success()
    assert br.state == "closed"


# ---------------------------------------------------------------------------
# supervised batcher
# ---------------------------------------------------------------------------

def _sup(fn, **over):
    kw = dict(name="test", failure_threshold=3, cooldown_s=0.1,
              restart_backoff_s=0.01, max_batch=4, max_wait_us=200, dim=4)
    kw.update(over)
    return SupervisedBatcher(fn, **kw)


def test_supervised_worker_restart(fitted):
    model, x = fitted
    calls = []

    def fn(xb):
        calls.append(len(xb))
        return np.zeros(len(xb), np.float32)

    with _sup(fn) as sup:
        assert sup.predict(x[0], timeout=30.0) == 0.0
        crash_supervised_workers(sup, crashes=2)
        for _ in range(2):                     # each crash fails its batch
            with pytest.raises(WorkerCrashed):
                sup.predict(x[0], timeout=30.0)
        # threshold 3 not reached: breaker still closed, third worker serves
        assert sup.predict(x[0], timeout=30.0) == 0.0
        st = sup.stats()
        assert st["crashes"] == 2 and st["restarts"] == 2
        assert st["breaker"]["state"] == "closed"
        assert st["restart_backoff_s"] == 0.01   # success reset the backoff


def test_crash_during_half_open_probe():
    def fn(xb):
        return np.zeros(len(xb), np.float32)

    with _sup(fn, failure_threshold=1, cooldown_s=0.15) as sup:
        crash_supervised_workers(sup, crashes=2)
        with pytest.raises(WorkerCrashed):
            sup.predict(np.zeros(4, np.float32), timeout=30.0)
        assert sup.breaker.state == "open"
        with pytest.raises(CircuitOpen):       # fast rejection, no worker
            sup.predict(np.zeros(4, np.float32), timeout=30.0)
        time.sleep(0.2)
        # the half-open probe runs on a RESTARTED worker — which crashes
        # too, so the probe fails and the breaker re-opens
        with pytest.raises(WorkerCrashed):
            sup.predict(np.zeros(4, np.float32), timeout=30.0)
        assert sup.breaker.state == "open"
        time.sleep(0.2)
        # third worker is clean: probe succeeds, breaker closes
        assert sup.predict(np.zeros(4, np.float32), timeout=30.0) == 0.0
        assert sup.breaker.state == "closed"
        assert sup.stats()["restarts"] == 2


def test_breaker_trips_on_model_errors_not_client_errors():
    def fn(xb):
        raise FaultInjected("sick model")

    with _sup(fn, failure_threshold=2, cooldown_s=5.0) as sup:
        for _ in range(2):
            with pytest.raises(FaultInjected):
                sup.predict(np.zeros(4, np.float32), timeout=30.0)
        # two model-error batches tripped it — callers now get CircuitOpen
        # without touching the worker
        with pytest.raises(CircuitOpen):
            sup.predict(np.zeros(4, np.float32), timeout=30.0)
        assert sup.breaker.stats()["rejected"] == 1


# ---------------------------------------------------------------------------
# runtime: adopt, canary, swap, quarantine
# ---------------------------------------------------------------------------

def test_runtime_adopts_and_serves(tmp_path, fitted):
    model, x = fitted
    rt = _runtime(tmp_path)
    with pytest.raises(ServingError):
        rt.predict(x[:2])                      # nothing published yet
    export_artifact(version_dir(str(tmp_path), 1), model)
    r = rt.poll_once()
    assert r["action"] == "swap" and r["canary"] == "pass"
    assert r["max_abs_err"] <= 1e-4            # golden agreement, recorded tol
    out = rt.predict(x[:2])
    assert out.shape == (2,) and np.isfinite(out).all()
    h = rt.health()
    assert h["ok"] and h["active_version"] == 1 and h["last_canary"][
        "verdict"] == "pass"


def test_canary_rejects_poisoned_on_disk(tmp_path, fitted):
    model, x = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path)
    rt.poll_once()
    base = rt.predict(x[:4], use_cache=False)
    # v2 exports HEALTHY (golden recorded from the good model), then the
    # bytes rot on disk — structural validation still passes (finite,
    # right shapes), only the canary can catch it
    export_artifact(version_dir(str(tmp_path), 2), model)
    assert poison_artifact_tables(version_dir(str(tmp_path), 2)) >= 1
    r = rt.poll_once()
    assert r["action"] == "canary_reject" and r["version"] == 2
    assert rt.active_version == 1
    np.testing.assert_array_equal(rt.predict(x[:4], use_cache=False), base)
    assert rt.poll_once()["action"] == "none"  # quarantined, never retried
    assert rt.health()["rejected_versions"] == [2]


def test_canary_poison_hook_rejects_clean_version(tmp_path, fitted):
    model, _ = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path)
    rt.poll_once()
    export_artifact(version_dir(str(tmp_path), 2), model)
    with canary_poison(rt, mode="nan"):
        r = rt.poll_once()
    assert r["action"] == "canary_reject"
    assert "non-finite" in r["reason"]
    assert rt.active_version == 1


def test_canary_absent_policy(tmp_path, fitted):
    model, _ = fitted
    # golden capture opted out at export: default policy swaps anyway
    # (verdict "absent"), require_golden rejects
    export_artifact(version_dir(str(tmp_path), 1), model, golden_queries=0)
    rt = _runtime(tmp_path)
    r = rt.poll_once()
    assert r["action"] == "swap" and r["canary"] == "absent"
    strict_root = tmp_path / "strict"
    export_artifact(version_dir(str(strict_root), 1), model,
                    golden_queries=0)
    rt2 = _runtime(strict_root, require_golden=True)
    r = rt2.poll_once()
    assert r["action"] == "canary_reject"
    assert rt2.active_version is None


def test_golden_block_in_meta(tmp_path, fitted):
    model, _ = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    from repro_torch.serve.artifact import GOLDEN_QUERIES, _read_meta
    from repro_torch.checkpoint.store import latest_step
    d = version_dir(str(tmp_path), 1)
    meta = _read_meta(d, latest_step(d))
    g = meta["golden"]
    assert len(g["x"]) == GOLDEN_QUERIES == len(g["y"])
    assert np.isfinite(np.asarray(g["y"], np.float64)).all()
    assert g["tol"] > 0
    assert meta["export_version"] == 1
    export_artifact(d, model)                  # re-export bumps the version
    meta2 = _read_meta(d, latest_step(d))
    assert meta2["export_version"] == 2


# ---------------------------------------------------------------------------
# swap atomicity, probation, rollback
# ---------------------------------------------------------------------------

def test_concurrent_predict_during_swap_bitwise_xor(tmp_path, fitted,
                                                    fitted_b):
    model_a, x = fitted
    model_b, _ = fitted_b
    export_artifact(version_dir(str(tmp_path), 1), model_a)
    rt = _runtime(tmp_path)
    rt.poll_once()
    q = x[:3]
    out_a = rt.predict(q, use_cache=False)
    export_artifact(version_dir(str(tmp_path), 2), model_b)
    stop = threading.Event()
    seen, errs = [], []

    def hammer():
        try:
            while not stop.is_set():
                seen.append(rt.predict(q, use_cache=False))
        except Exception as e:  # pragma: no cover - diagnostic
            errs.append(e)

    th = threading.Thread(target=hammer)
    th.start()
    try:
        r = rt.poll_once()                     # swap while requests fly
    finally:
        time.sleep(0.02)
        stop.set()
        th.join()
    assert not errs and r["action"] == "swap"
    out_b = rt.predict(q, use_cache=False)
    assert not np.array_equal(out_a, out_b)    # versions really differ
    assert len(seen) > 0
    for out in seen:                           # exactly old xor new — no mix
        assert (np.array_equal(out, out_a) or np.array_equal(out, out_b))


def test_probation_autorollback_on_error_rate(tmp_path, fitted):
    model, x = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path)
    rt.poll_once()                             # adopt v1 (no probation:
    assert rt.health()["probation"] is False   # nothing to fall back to)
    export_artifact(version_dir(str(tmp_path), 2), model)
    r = rt.poll_once()                         # v1 -> v2 swap arms probation
    assert r["action"] == "swap"
    assert rt.health()["probation"] is True
    rt.predictor.fault_plan = FaultPlan(serve_fail_every=1)
    for _ in range(20):
        try:
            rt.predict(x[:1], use_cache=False)
        except FaultInjected:
            pass
        if rt.active_version != 2:
            break
    rt.predictor.fault_plan = None
    assert rt.active_version == 1              # instant flip to retained v1
    assert rt.health()["probation"] is False
    assert 2 in rt.health()["rejected_versions"]
    assert np.isfinite(rt.predict(x[:2], use_cache=False)).all()
    assert rt.poll_once()["action"] == "none"  # v2 quarantined


def test_probation_nonfinite_trips_immediately(tmp_path, fitted):
    model, x = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path, probation_min_requests=10**6)  # rate gate off
    rt.poll_once()
    export_artifact(version_dir(str(tmp_path), 2), model)
    rt.poll_once()                             # v1 -> v2, probation armed
    assert rt.health()["probation"] is True
    # a single non-finite prediction must trip the rollback with NO
    # error-rate denominator — drive the runtime's own accounting (the
    # serving path feeds exactly these counters on a non-finite output)
    with rt._lock:
        rt._n_requests += 1
        rt._n_nonfinite += 1
    rt._maybe_autoroll()
    assert rt.active_version == 1
    assert 2 in rt.health()["rejected_versions"]
    assert np.isfinite(rt.predict(x[:2], use_cache=False)).all()


def test_rollback_exhausted(tmp_path, fitted):
    model, _ = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path, retain=0)          # nothing kept: no net to fall
    rt.poll_once()
    export_artifact(version_dir(str(tmp_path), 2), model)
    rt.poll_once()
    assert rt.active_version == 2
    assert rt.health()["retained_versions"] == []
    assert rt.rollback("forced") is False      # counted, not crashed
    assert rt.active_version == 2              # still serving the only copy


def test_rollback_depth_two(tmp_path, fitted):
    model, _ = fitted
    rt = _runtime(tmp_path, retain=2, probation_s=0.0)
    for v in (1, 2, 3):
        export_artifact(version_dir(str(tmp_path), v), model)
        rt.poll_once()
    assert rt.active_version == 3
    assert rt.health()["retained_versions"] == [1, 2]
    assert rt.rollback("bad 3") and rt.active_version == 2
    assert rt.rollback("bad 2") and rt.active_version == 1
    assert rt.rollback("bad 1") is False       # retained list exhausted
    assert rt.active_version == 1


def test_watcher_thread_adopts_new_version(tmp_path, fitted):
    model, x = fitted
    export_artifact(version_dir(str(tmp_path), 1), model)
    rt = _runtime(tmp_path)
    rt.poll_once()
    rt.start(interval_s=0.05)
    try:
        export_artifact(version_dir(str(tmp_path), 2), model)
        deadline = time.monotonic() + 30.0
        while rt.active_version != 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rt.active_version == 2          # live swap, no poll_once call
        assert np.isfinite(rt.predict(x[:2])).all()
    finally:
        rt.stop()


# ---------------------------------------------------------------------------
# health endpoint integration
# ---------------------------------------------------------------------------

def test_healthz_degraded_503_when_runtime_unhealthy(tmp_path):
    import json
    import urllib.error
    import urllib.request

    from repro_torch import obs

    rt = _runtime(tmp_path)                    # no version published: not ok
    assert rt.health()["ok"] is False
    srv = obs.serve_metrics(0)
    obs.add_health_provider("lifecycle", rt.health)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert ei.value.code == 503            # degraded, not error
        doc = json.loads(ei.value.read().decode())
        assert doc["status"] == "degraded"
        assert doc["components"]["lifecycle"]["active_version"] is None
    finally:
        obs.remove_health_provider("lifecycle")
        srv.close()
