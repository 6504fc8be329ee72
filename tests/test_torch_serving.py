"""The port's serving stack on the CPU: padding buckets and chunking, the
predictor against ``wlsh_krr_predict`` across buckets, the bucket-exact
cache (keys against the port's featurize and the JAX package's), the
micro-batcher's coalescing, deadlines, shedding, crash and close, and the
structured failures.  The card's graph path is in test_torch_gpu.py.

On the CPU the plain readout's mean over the instances is not pinned
across padding shapes, so served rows are held to ``wlsh_krr_predict`` to
4 ulp of max|pred| (ROADMAP.md queue C: the JAX package's bitwise pin
across shapes does not hold); the cache replays rows bit for bit."""
import threading
import time
import warnings
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_bucket_fn as jget
from repro.core.lsh import LSHParams as JLSH, featurize as jfeaturize
from repro_torch import core as T
from repro_torch.errors import (DeadlineExceeded, FaultInjected,
                                InvalidRequest, Overloaded, WorkerCrashed)
from repro_torch.launch import krr_serve
from repro_torch.serve import (BucketKeyFn, MicroBatcher, PredictionCache,
                               Predictor, bucket_sizes, export_artifact,
                               padding_bucket, percentile)
from repro_torch.testing.faults import FaultPlan, crash_worker


def _fit(seed=0, n=256, d=4, m=16, bucket=T.RECT):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=bucket),
                           lam=0.5, maxiter=100, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def fitted():
    return _fit()


def _predictor(tmp_path, model, **kw):
    export_artifact(str(tmp_path / "art"), model)
    pred = Predictor(device="cpu", **kw)
    pred.load(str(tmp_path / "art"))
    return pred


def _ulp_close(got, want, ulps=4):
    np.testing.assert_allclose(
        got, want, rtol=0.0, atol=ulps * np.spacing(np.abs(want).max()))


def test_padding_bucket_selection():
    assert [padding_bucket(b, 64) for b in (1, 2, 3, 5, 8, 9, 64, 200)] == \
        [1, 2, 4, 8, 8, 16, 64, 64]
    assert bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(1024) == tuple(1 << p for p in range(11))
    with pytest.raises(ValueError):
        padding_bucket(0, 64)
    with pytest.raises(ValueError):
        Predictor(device="cpu", max_batch=48)


def test_predictor_matches_library_across_buckets(fitted, tmp_path):
    """Every padding bucket serves ``wlsh_krr_predict``'s rows to 4 ulp;
    on the CPU nothing is captured (compile_count 0)."""
    model, x = fitted
    pred = _predictor(tmp_path, model)
    assert pred.warmup() == 0 and pred.compile_count() == 0
    for b in (1, 2, 3, 5, 8, 13, 33, 64, 100):
        _ulp_close(pred.predict(x[:b]),
                   T.wlsh_krr_predict(model, x[:b]).numpy())
    one = pred.predict(x[7])
    assert np.ndim(one) == 0
    _ulp_close(np.asarray([one]), T.wlsh_krr_predict(model, x[7:8]).numpy())


def test_predictor_chunks_above_max_batch(fitted, tmp_path):
    model, x = fitted
    pred = _predictor(tmp_path, model, max_batch=16)
    got = pred.predict(x[:40])        # chunks of 16, 16, 8
    assert got.shape == (40,)
    _ulp_close(got, T.wlsh_krr_predict(model, x[:40]).numpy())
    assert pred.health()["warm_calls"] == 1


def test_predictor_hosts_multiple_models(tmp_path):
    m1, x1 = _fit(10)
    m2, _ = _fit(11, m=8)
    export_artifact(str(tmp_path / "a1"), m1)
    export_artifact(str(tmp_path / "a2"), m2)
    pred = Predictor(device="cpu")
    pred.load(str(tmp_path / "a1"))
    pred.load(str(tmp_path / "a2"))
    assert pred.artifact_ids == ["a1", "a2"]
    _ulp_close(pred.predict(x1[:32], artifact_id="a1"),
               T.wlsh_krr_predict(m1, x1[:32]).numpy())
    _ulp_close(pred.predict(x1[:32], artifact_id="a2"),
               T.wlsh_krr_predict(m2, x1[:32]).numpy())
    with pytest.raises(KeyError):
        pred.predict(x1[:32], artifact_id="missing")
    assert pred.unload("a1") and not pred.unload("a1")
    assert pred.artifact_ids == ["a2"]


def test_unload_releases_the_model(fitted, tmp_path):
    """After unload nothing of the predictor holds the model's tables: they
    are freed (by reference count, with no collection pass)."""
    model, x = fitted
    pred = _predictor(tmp_path, model, cache_entries=16)
    pred.predict(x[:3])
    tables = weakref.ref(pred._hosted("art").loaded.model.tables)
    assert tables() is not None
    pred.unload("art")
    assert tables() is None


def test_numpy_bucket_keys_match_port_and_jax(fitted):
    """The cache's numpy keys equal the port's featurize keys and the JAX
    package's, bitwise, also for points far out of the training box."""
    model, x = fitted
    lsh = model.lsh
    xq = np.concatenate([x[:50], (x[:10] * 1e4).astype(np.float32),
                         -x[:10]])
    keys, _, _ = BucketKeyFn(lsh, T.RECT).bucket_ids(xq)
    feats = T.featurize(lsh, T.RECT, torch.from_numpy(xq))
    np.testing.assert_array_equal(keys[0].T, feats.key1.numpy())
    np.testing.assert_array_equal(keys[1].T, feats.key2.numpy())
    jl = JLSH(*(jnp.asarray(t.numpy()) for t in lsh))
    jf = jfeaturize(jl, jget("rect"), jnp.asarray(xq))
    np.testing.assert_array_equal(keys[0].T, np.asarray(jf.key1))
    np.testing.assert_array_equal(keys[1].T, np.asarray(jf.key2))


def test_cache_hit_bitwise_matches_cold_path(fitted, tmp_path):
    model, x = fitted
    cached = _predictor(tmp_path / "c", model, cache_entries=1024)
    cold = _predictor(tmp_path / "n", model)
    first = cached.predict(x[:64])                 # misses: warm path
    hits = cached.predict(x[:64])                  # all bucket-key hits
    stats = cached.cache_stats()
    assert stats["hits"] == 64 and stats["misses"] == 64
    np.testing.assert_array_equal(hits, first)
    np.testing.assert_array_equal(hits, cold.predict(x[:64]))
    assert cold.cache_stats() is None
    cached.clear_cache()
    assert cached.cache_stats()["entries"] == 0


def test_cache_same_bucket_query_is_exact_for_rect(fitted, tmp_path):
    """For rect a DIFFERENT point in the same m buckets hits, and the
    replayed value equals that point's own cold-path prediction, bitwise."""
    model, x = fitted
    pred = _predictor(tmp_path, model, cache_entries=1024)
    keyfn = BucketKeyFn(model.lsh, T.RECT)
    x0 = x[:1]
    x1 = None
    for eps in (1e-4, 1e-5, 1e-6):
        cand = (x0 + eps).astype(np.float32)
        if keyfn(cand) == keyfn(x0) and not np.array_equal(cand, x0):
            x1 = cand
            break
    assert x1 is not None, "no same-bucket perturbation found"
    cold = np.asarray(pred.predict(x1[0], use_cache=False))
    pred.predict(x0[0])
    st0 = pred.cache_stats()
    out = pred.predict(x1[0])
    assert pred.cache_stats()["hits"] == st0["hits"] + 1
    np.testing.assert_array_equal(out, cold)


def test_cache_nonrect_requires_identical_point():
    model, x = _fit(7, bucket=T.TENT)
    keyfn = BucketKeyFn(model.lsh, T.TENT)
    x0 = x[:1]
    assert keyfn(x0) == keyfn(x0)
    assert keyfn((x0 + 1e-5).astype(np.float32)) != keyfn(x0)
    assert not keyfn.exact_within_bucket


def test_cache_keys_nonfinite_rows_warning_free(fitted):
    model, _ = fitted
    keyfn = BucketKeyFn(model.lsh, T.RECT)
    bad = np.zeros((3, 4), np.float32)
    bad[0, 0], bad[1, 1], bad[2, 2] = np.nan, np.inf, 3e9
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        keys = keyfn(bad)
    assert all(k.startswith(b"!raw") for k in keys)
    assert len(set(keys)) == 3 and keyfn(bad) == keys


def test_cache_lru_eviction_and_stats():
    cache = PredictionCache(max_entries=2)
    cache.put_many([b"a", b"b"], [np.float32(1), np.float32(2)])
    assert cache.get_many([b"a"]) == [np.float32(1)]
    cache.put_many([b"c"], [np.float32(3)])
    out = cache.get_many([b"b", b"a", b"c"])
    assert out[0] is None and out[1] == 1 and out[2] == 3
    st = cache.stats()
    assert st["evictions"] == 1 and st["entries"] == 2 and len(cache) == 2
    with pytest.raises(ValueError):
        PredictionCache(max_entries=0)


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert percentile(vals, 50) == 50 and percentile(vals, 99) == 99
    assert np.isnan(percentile([], 50))


def test_batcher_roundtrips_and_coalesces(fitted, tmp_path):
    """200 single-row requests coalesce into fewer batches; each answer is
    the row's serial answer to 4 ulp (its bucket may differ)."""
    model, x = fitted
    pred = _predictor(tmp_path, model, cache_entries=4096)
    expect = pred.predict(x[:50], use_cache=False)
    with MicroBatcher(lambda xb: pred.predict(xb), max_batch=16,
                      max_wait_us=5000) as mb:
        futures = [mb.submit(x[i % 50]) for i in range(200)]
        results = np.array([f.result(timeout=30) for f in futures])
        stats = mb.stats()
    assert stats["served"] == 200 and stats["batches"] < 200
    assert stats["mean_batch"] > 1.0
    assert 0 < stats["p50_us"] <= stats["p99_us"]
    _ulp_close(results, expect[np.arange(200) % 50])


def test_batcher_deadline_flushes_lone_request(fitted, tmp_path):
    model, x = fitted
    pred = _predictor(tmp_path, model)
    with MicroBatcher(lambda xb: pred.predict(xb), max_batch=64,
                      max_wait_us=1000) as mb:
        out = mb.submit(x[0]).result(timeout=10)
    np.testing.assert_array_equal(np.asarray(out), pred.predict(x[0]))


def test_batcher_propagates_predict_errors():
    def boom(xb):
        raise RuntimeError("model exploded")
    with MicroBatcher(boom, max_batch=4, max_wait_us=100) as mb:
        with pytest.raises(RuntimeError, match="model exploded"):
            mb.submit(np.zeros((3,), np.float32)).result(timeout=10)


def test_batcher_rejects_wrong_dim_without_failing_batch():
    def echo(xb):
        return np.zeros((len(xb),), np.float32)

    with MicroBatcher(echo, max_batch=8, max_wait_us=5000, dim=3) as mb:
        good = [mb.submit(np.zeros((3,), np.float32)) for _ in range(4)]
        with pytest.raises(ValueError, match="features"):
            mb.submit(np.zeros((7,), np.float32))
        assert all(f.result(timeout=10) == 0.0 for f in good)
    with MicroBatcher(echo, max_batch=8, max_wait_us=100) as mb:
        mb.submit(np.zeros((5,), np.float32)).result(timeout=10)
        with pytest.raises(ValueError, match="features"):
            mb.submit(np.zeros((4,), np.float32))


def test_batcher_close_drains_and_rejects_new():
    served = []

    def slow(xb):
        served.append(len(xb))
        return np.zeros((len(xb),), np.float32)

    mb = MicroBatcher(slow, max_batch=8, max_wait_us=50)
    futs = [mb.submit(np.zeros((2,), np.float32)) for _ in range(20)]
    mb.close()
    assert all(f.done() for f in futs) and sum(served) == 20
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((2,), np.float32))


def test_batcher_threaded_submitters(fitted, tmp_path):
    model, x = fitted
    pred = _predictor(tmp_path, model, cache_entries=4096)
    expect = pred.predict(x[:40], use_cache=False)
    got = np.full(40, np.nan, np.float32)
    errs = []
    with MicroBatcher(lambda xb: pred.predict(xb), max_batch=32,
                      max_wait_us=2000) as mb:
        def client(rows):
            try:
                for i in rows:
                    got[i] = mb.submit(x[i]).result(timeout=30)
            except Exception as e:
                errs.append(e)
        threads = [threading.Thread(target=client, args=(range(j, 40, 4),))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    # the batcher coalesces into varying buckets: ulp of max|pred|, as
    # every cross-bucket comparison here (a row's own ulp is no bound on
    # the CPU, where a small prediction sums larger terms)
    _ulp_close(got, expect)


def test_batcher_worker_crash_fails_all_futures_and_fast_fails_submit():
    gate = threading.Event()

    def slow_predict(xb):
        gate.wait(5.0)
        return np.zeros((xb.shape[0],), np.float32)

    mb = MicroBatcher(slow_predict, max_batch=4, max_wait_us=500, dim=2)
    crash_worker(mb)
    futs = [mb.submit(np.zeros(2, np.float32)) for _ in range(6)]
    gate.set()
    for f in futs:
        with pytest.raises(WorkerCrashed):
            f.result(timeout=10.0)
    assert mb.stats()["crashed"]
    with pytest.raises(WorkerCrashed):
        mb.submit(np.zeros(2, np.float32))
    mb.close()


def test_batcher_load_shedding_returns_overloaded():
    gate = threading.Event()

    def gated_predict(xb):
        gate.wait(10.0)
        return np.arange(xb.shape[0]).astype(np.float32)

    with MicroBatcher(gated_predict, max_batch=1, max_wait_us=100,
                      dim=2, max_queue=2) as mb:
        futs = [mb.submit(np.zeros(2, np.float32)) for _ in range(12)]
        shed = [f for f in futs if f.done()
                and isinstance(f.exception(), Overloaded)]
        assert shed and shed[0].exception().queue_depth >= 2
        gate.set()
        served = sum(f.result(timeout=10.0) is not None
                     for f in futs if f not in shed)
        stats = mb.stats()
    assert stats["shed"] == len(shed) and served == 12 - len(shed)
    assert stats["shed_rate"] == pytest.approx(len(shed) / 12)


def test_batcher_deadline_expires_queued_requests():
    gate = threading.Event()
    calls = []

    def gated_predict(xb):
        calls.append(xb.shape[0])
        gate.wait(10.0)
        return np.zeros((xb.shape[0],), np.float32)

    with MicroBatcher(gated_predict, max_batch=1, max_wait_us=100,
                      dim=2) as mb:
        f1 = mb.submit(np.zeros(2, np.float32))
        f2 = mb.submit(np.ones(2, np.float32), deadline_us=10_000)
        time.sleep(0.1)
        gate.set()
        assert f1.result(timeout=10.0) is not None
        with pytest.raises(DeadlineExceeded) as ei:
            f2.result(timeout=10.0)
        assert ei.value.waited_s >= 0.01
        stats = mb.stats()
    assert stats["deadline_expired"] == 1 and calls.count(1) == 1


def test_predictor_rejects_nan_query_structured(fitted, tmp_path):
    model, x = fitted
    pred = _predictor(tmp_path, model, cache_entries=64)
    bad = x[:4].copy()
    bad[2, 0] = np.nan
    with pytest.raises(InvalidRequest, match=r"\[2\]"):
        pred.predict(bad)
    with pytest.raises(InvalidRequest):
        pred.predict(np.full((4,), np.inf, np.float32))
    assert np.isfinite(pred.predict(x[:4])).all()
    h = pred.health()
    assert h["errors"] == 2 and "InvalidRequest" in h["last_error"]


def test_predictor_health_snapshot_with_batcher(fitted, tmp_path):
    model, x = fitted
    pred = _predictor(tmp_path, model)
    with MicroBatcher(lambda xb: pred.predict(xb), max_batch=8,
                      max_wait_us=500) as mb:
        pred.attach_batcher(mb)
        for row in x[:8]:
            mb.submit(row).result(timeout=10.0)
        h = pred.health()
    assert h["ok"] and h["models"] == ["art"]
    assert h["requests"] >= 1 and h["errors"] == 0
    assert h["batcher"]["queue_depth"] == 0 and not h["batcher"]["crashed"]


def test_predictor_fault_plan_drives_serve_failures(fitted, tmp_path):
    model, x = fitted
    export_artifact(str(tmp_path / "art"), model)
    pred = Predictor(device="cpu", fault_plan=FaultPlan(serve_fail_every=2))
    pred.load(str(tmp_path / "art"))
    assert np.isfinite(pred.predict(x[:2])).all()
    with pytest.raises(FaultInjected):
        pred.predict(x[:2])
    assert np.isfinite(pred.predict(x[:2])).all()
    assert pred.health()["errors"] == 1


def test_predictor_fault_plan_stalls_warm_path(fitted, tmp_path):
    model, x = fitted
    export_artifact(str(tmp_path / "art"), model)
    pred = Predictor(device="cpu", fault_plan=FaultPlan(serve_delay_s=0.05))
    pred.load(str(tmp_path / "art"))
    t0 = time.perf_counter()
    pred.predict(x[:2])
    assert time.perf_counter() - t0 >= 0.05


def test_serve_cli_selftest_with_metrics_endpoint(capsys):
    """The CLI's selftest on the CPU, with the live /metrics + /healthz
    endpoint scraped for every required series."""
    rc = krr_serve.main(["--selftest", "--device", "cpu",
                         "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "selftest ok" in out and "metrics endpoint verified" in out
