"""The port's multi-axis data grid (one linear data axis), the elastic
restore onto a grid, and the device default of the host-side draws.

* a (pod, data) grid is one linear data axis (``launch/mesh.py``): the
  psum and hash-join steps on four data ranks match the JAX package's step
  on one device (one spawn of four gloo ranks);
* ``restore_resharded`` hands each rank of a (model, data) grid its slice
  of each leaf, from the port's checkpoints and the JAX package's alike;
* ``sample_lsh_params``, ``rff_draw`` and ``sample_sharded_lsh`` put their
  draw on the card unless asked for the CPU, and raise without one.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import core as T
from repro_torch.checkpoint import restore_resharded, save_checkpoint
from repro_torch.core.distributed import sample_sharded_lsh
from repro_torch.launch.mesh import (Mesh, init_distributed, local_lsh,
                                     make_host_mesh)
from repro_torch.testing.multirank import assemble, spawn_ranks

no_card = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the no-card path")


@no_card
@pytest.mark.parametrize("draw", [
    lambda dev: T.sample_lsh_params(np.random.default_rng(0), 4, 3,
                                    T.GammaPDF(), device=dev),
    lambda dev: T.rff_draw(np.random.default_rng(0), 3, 8, device=dev),
    lambda dev: sample_sharded_lsh(np.random.default_rng(0), 4, 3,
                                   T.GammaPDF(), device=dev),
], ids=["sample_lsh_params", "rff_draw", "sample_sharded_lsh"])
def test_draws_default_to_the_card(draw):
    """No device means the card: without one the draw raises, and
    device='cpu' gives host tensors."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        draw(None)
    out = draw("cpu")
    assert all(t.device.type == "cpu" for t in out)


def test_sample_sharded_lsh_shards_by_model_rank():
    """The sharded draw is the host draw under the JAX package's name;
    ``local_lsh`` hands each model rank its rows of it, in order."""
    assert sample_sharded_lsh is T.sample_lsh_params
    full = sample_sharded_lsh(np.random.default_rng(5), 8, 3,
                              T.GammaPDF(2.0, 1.0), 1.5, device="cpu")
    parts = [local_lsh(_fake_mesh(2, 1, i, 0), full) for i in range(2)]
    for t, a, b in zip(full, *parts):
        assert a.shape == (4, 3)
        assert torch.equal(torch.cat([a, b]), t)


def test_backend_is_named_and_model_must_divide(tmp_path):
    """``init_distributed(backend=...)`` takes the backend by name; a grid
    whose model extent does not divide the world is refused."""
    own = not dist.is_initialized()
    if own:
        init_distributed("cpu", backend="gloo",
                         init_method=f"file://{tmp_path}/store", rank=0,
                         world_size=1)
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_host_mesh(device="cpu")
        assert (mesh.data_rank, mesh.model_rank, mesh.data, mesh.model) == \
            (0, 0, 1, 1)
        for bad in (2, 0):
            with pytest.raises(ValueError, match=f"model_parallel={bad}"):
                make_host_mesh(bad, device="cpu")
    finally:
        if own:
            dist.destroy_process_group()


def _fake_mesh(model, data, model_rank, data_rank):
    return Mesh(data=data, model=model, data_rank=data_rank,
                model_rank=model_rank, data_group=None, model_group=None,
                device=torch.device("cpu"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restore_resharded_gives_each_rank_its_slice(tmp_path, writer):
    rng = np.random.default_rng(3)
    state = {"tables": rng.standard_normal((4, 8, 2)).astype(np.float32),
             "w": rng.standard_normal((4, 3)).astype(np.float32),
             "step": np.asarray(7, np.int32)}
    if writer == "jax":
        from repro.checkpoint import save_checkpoint as jax_save
        jax_save(str(tmp_path), 3, state, {"by": "jax"})
    else:
        save_checkpoint(str(tmp_path), 3, state, {"by": "port"})
    template = {k: np.zeros_like(v) for k, v in state.items()}
    placement = {"['tables']": ("model", "data"), "['w']": ("model",)}
    rows = []
    for i in range(2):
        row = []
        for j in range(2):
            got, step, meta = restore_resharded(
                str(tmp_path), template, placement, _fake_mesh(2, 2, i, j))
            assert step == 3 and meta["by"] == writer
            assert torch.equal(got["w"], torch.from_numpy(
                state["w"][2 * i:2 * i + 2]))
            assert int(got["step"]) == 7          # replicated
            row.append(got["tables"].numpy())
        rows.append(np.concatenate(row, 1))
    np.testing.assert_array_equal(np.concatenate(rows), state["tables"])


def test_restore_resharded_refuses_bad_specs(tmp_path):
    state = {"t": np.zeros((3, 4), np.float32)}
    save_checkpoint(str(tmp_path), 1, state)
    mesh = _fake_mesh(2, 2, 0, 0)
    with pytest.raises(KeyError, match="names no leaf"):
        restore_resharded(str(tmp_path), state, {"['u']": ("model",)}, mesh)
    with pytest.raises(ValueError, match="does not split"):
        restore_resharded(str(tmp_path), state, {"['t']": ("model",)}, mesh)
    with pytest.raises(ValueError, match="unknown axis"):
        restore_resharded(str(tmp_path), state, {"['t']": (None, "pod")},
                          mesh)


@pytest.fixture(scope="module")
def data_axis4(tmp_path_factory):
    """Four gloo ranks as one data axis of 4: a (pod 2, data 2) grid laid
    out as the JAX package's linear index over its data axes.  The psum
    and hash-join steps, in one spawn."""
    rng = np.random.default_rng(4)
    n, nq, d, m = 128, 32, 3, 8
    x = rng.uniform(0.0, 2.0, (n, d)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    xq = rng.uniform(0.0, 2.0, (nq, d)).astype(np.float32)
    lsh = T.sample_lsh_params(rng, m, d, T.GammaPDF(2.0, 1.0), device="cpu")
    inputs = dict(x=x, y=y, xq=xq,
                  **{k: v.numpy() for k, v in zip(("w", "z", "r1", "r2"),
                                                  lsh)})
    cfg = dict(m=m, table_size=512, lam=0.5, cg_iters=20)
    jobs = [("psum", dict(mode="psum", cfg=cfg)),
            ("hashjoin", dict(mode="hashjoin", cfg=cfg, wire="f32"))]
    res = spawn_ranks(4, 1, str(tmp_path_factory.mktemp("axis4")), inputs,
                      jobs)
    return res, inputs, cfg


@pytest.fixture(scope="module")
def jax_single_host(data_axis4):
    """The JAX package's psum step and predict on one device, on
    ``data_axis4``'s inputs: (beta, predictions)."""
    import jax
    from repro.compat import make_mesh
    from repro.core import distributed as JD
    from repro.core import get_bucket_fn
    from repro.core.lsh import LSHParams as JLSH
    _, inputs, cfg = data_axis4
    jl = JLSH(*(inputs[k] for k in ("w", "z", "r1", "r2")))
    mesh = make_mesh((1, 1), ("data", "model"))
    jcfg = JD.KRRStepConfig(**cfg, data_axes=("data",), model_axis="model",
                            backend="reference")
    f = get_bucket_fn("rect")
    beta, _, tables = jax.jit(JD.make_krr_step(mesh, jcfg, f))(
        inputs["x"], inputs["y"], jl)
    pred = jax.jit(JD.make_krr_predict(mesh, jcfg, f))(inputs["xq"], jl,
                                                      tables)
    return np.asarray(beta), np.asarray(pred)


def test_data_axis_layout(data_axis4):
    """Rank r sits at linear data index r = pod * 2 + data (row-major over
    pod, data, model), model index 0."""
    res, _, _ = data_axis4
    got = [(r["data_rank"], r["model_rank"]) for r in res]
    assert got == [(0, 0), (1, 0), (2, 0), (3, 0)]


@pytest.mark.parametrize("mode", ["psum", "hashjoin"])
def test_data_axis_step_matches_jax(data_axis4, jax_single_host, mode):
    """The step on four data ranks against the JAX package's step on one
    device, on the same inputs: beta and predictions within 1e-5 of
    their max (the tolerance of tests/test_torch_distributed.py)."""
    res = data_axis4[0]
    beta, pred = jax_single_host
    key = "pred" if mode == "psum" else "pred_dedup0"
    got_beta = assemble(res, mode, "beta")
    assert got_beta.shape == (128,) and np.isfinite(got_beta).all()
    np.testing.assert_allclose(got_beta, beta, rtol=0,
                               atol=1e-5 * np.abs(beta).max())
    for k in (key,) + (("pred_dedup1",) if mode == "hashjoin" else ()):
        np.testing.assert_allclose(assemble(res, mode, k), pred, rtol=0,
                                   atol=1e-5 * np.abs(pred).max())
