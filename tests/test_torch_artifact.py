"""Serving artifacts across the two packages, on the CPU: an artifact the
JAX package exported loads in the port and reproduces its golden block, one
the port exported loads in the JAX package and passes its canary, and the
port's loader refuses what the JAX loader refuses.  The JAX side runs with
backend='reference', as its own serving tests do."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import WLSHKernelSpec as JSpec, get_bucket_fn as jget
from repro.core import krr as jkrr
from repro import serve as jserve
from repro_torch import core as T
from repro_torch.serve import (Normalization, Predictor, export_artifact,
                               load_artifact)
from repro_torch.serve import artifact as art_mod


def _jax_fit(seed=0, n=256, d=4, m=16, k_rhs=0):
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, (n, d)) * 2.0
    y = jax.random.normal(jax.random.fold_in(key, 1),
                          (n, k_rhs) if k_rhs else (n,))
    model = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y,
                              JSpec(bucket=jget("rect")), m=m, lam=0.5,
                              maxiter=100, backend="reference")
    return model, np.asarray(x, np.float32)


def _port_fit(seed=0, n=256, d=4, m=16, k_rhs=0, bucket=T.RECT):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, d)).astype(np.float32)
    y = rng.standard_normal((n, k_rhs) if k_rhs else (n,)).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    model = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=bucket),
                           lam=0.5, maxiter=100, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def port_fitted():
    return _port_fit()


@pytest.mark.parametrize("k_rhs", [0, 3])
def test_jax_artifact_loads_in_port_and_reproduces_golden(tmp_path, k_rhs):
    """The port serves a JAX-exported artifact: its own golden block within
    the recorded tol, and the JAX package's predictions within 1e-5 of
    max|pred| (the two sum the readout in another order)."""
    jm, x = _jax_fit(k_rhs=k_rhs)
    jserve.export_artifact(str(tmp_path / "art"), jm)
    loaded = load_artifact(str(tmp_path / "art"), device="cpu")
    assert loaded.meta["backend"] == "reference"
    assert loaded.model.tables.shape == tuple(jm.tables.shape)
    pred = Predictor(device="cpu")
    pred.add_model(loaded)
    golden = loaded.meta["golden"]
    got = pred.predict(np.asarray(golden["x"], np.float32))
    assert np.abs(got - np.asarray(golden["y"], np.float32)).max() \
        <= golden["tol"]
    want = np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(x[:40])))
    out = pred.predict(x[:40])
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_port_artifact_loads_in_jax_and_passes_its_canary(tmp_path,
                                                          port_fitted):
    """A port-exported artifact is a JAX artifact: the JAX loader takes it
    (backend 'reference' for a fit on the CPU, the port's provenance under
    'framework'), and the JAX ServingRuntime's canary passes it."""
    model, x = port_fitted
    export_artifact(str(tmp_path / "v" / "v1"), model, artifact_id="p")
    jl = jserve.load_artifact(str(tmp_path / "v" / "v1"))
    assert jl.meta["backend"] == "reference"
    assert jl.meta["framework"] == "torch"
    assert isinstance(jl.meta["cg_iters"], int)
    assert isinstance(jl.meta["cg_resnorm"], float)
    rt = jserve.ServingRuntime(str(tmp_path / "v"), backend="reference",
                               config=jserve.LifecycleConfig(
                                   require_golden=True))
    report = rt.poll_once()
    assert report["action"] == "swap" and report["canary"] == "pass"
    want = T.wlsh_krr_predict(model, x[:40]).numpy()
    got = np.asarray(jkrr.wlsh_krr_predict(jl.model, jnp.asarray(x[:40])))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_port_roundtrip_bitwise(tmp_path, port_fitted):
    """Export -> load in the port gives the same arrays and the same
    predictions, bit for bit (npz is bitwise; the same plain path runs)."""
    model, x = port_fitted
    export_artifact(str(tmp_path / "art"), model)
    loaded = load_artifact(str(tmp_path / "art"), device="cpu")
    assert loaded.artifact_id == "art"
    for a, b in zip(loaded.model.lsh, model.lsh):
        assert torch.equal(a, b)
    assert torch.equal(loaded.model.beta, model.beta)
    assert torch.equal(loaded.model.tables, model.tables)
    assert torch.equal(
        loaded.operator.predict_batched(loaded.model.tables, x[:64]),
        T.wlsh_krr_predict(model, x[:64]))


def test_port_roundtrip_multirhs(tmp_path):
    model, x = _port_fit(seed=3, k_rhs=3)
    export_artifact(str(tmp_path / "art"), model)
    loaded = load_artifact(str(tmp_path / "art"), device="cpu")
    assert tuple(loaded.model.tables.shape) == tuple(model.tables.shape)
    assert torch.equal(T.wlsh_krr_predict(loaded.model, x[:32]),
                       T.wlsh_krr_predict(model, x[:32]))
    out = Predictor(device="cpu")
    out.add_model(loaded)
    assert out.predict(x[:5]).shape == (5, 3)


def test_artifact_validates_metadata(tmp_path, port_fitted):
    """The JAX test's malformed cases, on the port's loader: a wrong table
    size, an unknown bucket function, a format newer than the reader."""
    model, _ = port_fitted
    art = str(tmp_path / "art")
    export_artifact(art, model)
    step_dir = os.path.join(art, "step_1")
    meta_path = os.path.join(step_dir, "meta.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    with open(meta_path, "w") as fh:
        json.dump(dict(meta, table_size=meta["table_size"] * 2), fh)
    with pytest.raises(ValueError, match="tables"):
        load_artifact(art, device="cpu")
    with open(meta_path, "w") as fh:
        json.dump(dict(meta, bucket_name="nope"), fh)
    with pytest.raises(ValueError, match="bucket"):
        load_artifact(art, device="cpu")
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    os.rename(step_dir, os.path.join(art, "step_99"))
    with pytest.raises(ValueError, match="format"):
        load_artifact(art, device="cpu")


def test_artifact_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_artifact(str(tmp_path / "nothing"), device="cpu")


def test_artifact_rejects_nonfinite_tables(tmp_path, port_fitted):
    """NaN in the tables is refused at load, by both packages."""
    model, _ = port_fitted
    tables = model.tables.clone()
    tables[0, 0] = float("nan")
    export_artifact(str(tmp_path / "bad"), model._replace(tables=tables),
                    golden_queries=0)
    with pytest.raises(ValueError, match="non-finite"):
        load_artifact(str(tmp_path / "bad"), device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        jserve.load_artifact(str(tmp_path / "bad"))


def test_artifact_normalization_roundtrip(tmp_path):
    """Normalization stats travel with the artifact: the port predicts
    ``f((x - mean) / std) * y_std + y_mean`` within 1e-5, and the JAX
    package serves the port's artifact the same way."""
    model, x = _port_fit(seed=4)
    norm = Normalization(x_mean=np.full((4,), 0.5, np.float32),
                         x_std=np.full((4,), 2.0, np.float32),
                         y_mean=1.5, y_std=3.0)
    export_artifact(str(tmp_path / "art"), model, norm=norm)
    pred = Predictor(device="cpu")
    pred.load(str(tmp_path / "art"))
    xq = x[:16]
    direct = T.wlsh_krr_predict(model, (xq - 0.5) / 2.0).numpy() * 3.0 + 1.5
    np.testing.assert_allclose(pred.predict(xq), direct, atol=1e-5)
    jpred = jserve.Predictor(backend="reference")
    jpred.load(str(tmp_path / "art"))
    np.testing.assert_allclose(jpred.predict(xq), direct, atol=1e-5)


def test_artifact_without_beta_serves_identically(tmp_path, port_fitted):
    """include_beta=False drops the training solution; serving never reads
    it, so predictions are unchanged, bit for bit."""
    model, x = port_fitted
    export_artifact(str(tmp_path / "full"), model)
    export_artifact(str(tmp_path / "lean"), model, include_beta=False)
    full = load_artifact(str(tmp_path / "full"), device="cpu")
    lean = load_artifact(str(tmp_path / "lean"), device="cpu")
    assert lean.model.beta.shape[0] == 0 and not lean.meta["has_beta"]
    assert torch.equal(
        lean.operator.predict_batched(lean.model.tables, x[:32]),
        full.operator.predict_batched(full.model.tables, x[:32]))


def test_export_version_increments(tmp_path, port_fitted):
    model, _ = port_fitted
    export_artifact(str(tmp_path / "art"), model)
    export_artifact(str(tmp_path / "art"), model)
    assert load_artifact(str(tmp_path / "art"),
                         device="cpu").meta["export_version"] == 2


def test_artifact_load_retries_transient_io(tmp_path, port_fitted,
                                            monkeypatch):
    """Transient I/O failures retry with backoff; retries=0 raises."""
    model, _ = port_fitted
    export_artifact(str(tmp_path / "art"), model)
    real_once = art_mod._load_artifact_once
    fails = {"n": 2}

    def flaky(directory, *args, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient read failure")
        return real_once(directory, *args, **kw)

    monkeypatch.setattr(art_mod, "_load_artifact_once", flaky)
    with pytest.raises(OSError):
        load_artifact(str(tmp_path / "art"), device="cpu")
    fails["n"] = 2
    loaded = load_artifact(str(tmp_path / "art"), device="cpu", retries=3,
                           retry_backoff_s=0.01)
    assert loaded.artifact_id == "art" and fails["n"] == 0


def test_load_defaults_to_the_card(tmp_path, port_fitted):
    """device=None means the card; without one the load raises rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    model, _ = port_fitted
    export_artifact(str(tmp_path / "art"), model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(str(tmp_path / "art"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor()
    from repro_torch.serve import ServingRuntime
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingRuntime(str(tmp_path / "versions"))


def test_card_backend_name_passes_the_jax_canary(tmp_path, port_fitted):
    """An artifact exported on the card records backend 'pallas' (the
    Pallas kernels' counterparts ran the fit); the JAX package rebuilds its
    operator from that name and its canary passes (Pallas in interpret
    mode on the CPU), and the port loads it on any device."""
    model, _ = port_fitted
    d = str(tmp_path / "v" / "v1")
    export_artifact(d, model)
    meta_path = os.path.join(d, "step_1", "meta.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    with open(meta_path, "w") as fh:
        json.dump(dict(meta, backend="pallas"), fh)
    rt = jserve.ServingRuntime(str(tmp_path / "v"),
                               config=jserve.LifecycleConfig(
                                   require_golden=True, warm_sizes=(16,)))
    report = rt.poll_once()
    assert report["action"] == "swap" and report["canary"] == "pass"
    assert load_artifact(d, device="cpu").meta["backend"] == "pallas"
