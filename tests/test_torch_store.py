"""The port's checkpoint store and solve persistence against the JAX
package's, on the CPU: the same npz keys, checkpoints that restore across
the two packages, a killed writer's tmp dir kept invisible, and a preempted
fit that resumes from a state written by either package."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import WLSHKernelSpec as JSpec, get_bucket_fn as jget
from repro.core import krr as jkrr
from repro.core import sample_lsh_params as jsample
from repro.core.lsh import GammaPDF as JGamma
from repro.errors import FaultInjected as JFaultInjected
from repro.testing import faults as jfaults
from repro_torch import core as T
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import store as tstore
from repro_torch.convert import lsh_from_reference
from repro_torch.core.krr import _stored_solve_state
from repro_torch.errors import FaultInjected
from repro_torch.testing.faults import killed_checkpoint_writer, preempt_after


def _state_arrays(seed, n=7, k=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(n, k), r=f(n, k), p=f(n, k), rs=f(k), rho=f(k),
                active=np.array([True, False][:k]),
                col_iters=np.array([3, 9][:k], np.int32))


def _jax_state(a, it=5):
    return jkrr.SolveState(it=np.asarray(it, np.int32), **a)


def _torch_state(a, it=5):
    """The port's state in the form its fit stores (``it`` a 0-d int32
    array, as the JAX package keeps it; a Python int in the solver)."""
    st = T.SolveState(it=it, **{k: torch.from_numpy(v.copy())
                                for k, v in a.items()})
    return _stored_solve_state(st)


def test_npz_keys_match_jax_keystr():
    """Dict, NamedTuple (``SolveState``: .x .r .p .rs .rho .active .it
    .col_iters), list and nesting give the JAX package's keystr keys, and
    the same arrays, bitwise."""
    a = _state_arrays(0)
    tree_np = {"tables": a["x"], "lsh": [a["rs"], a["rho"]],
               "solve": _jax_state(a)}
    tree_t = {"tables": torch.from_numpy(a["x"]),
              "lsh": [torch.from_numpy(a["rs"]), torch.from_numpy(a["rho"])],
              "solve": _torch_state(a)}
    want = jstore._flatten(tree_np)
    got = tstore._flatten(tree_t)
    assert list(got) == list(want)
    assert {".x", ".r", ".p", ".rs", ".rho", ".active", ".it",
            ".col_iters"} == set(tstore._flatten(_torch_state(a)))
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A checkpoint of a dict and of a ``SolveState`` written by one
    package restores in the other, bitwise, with its meta."""
    a = _state_arrays(1)
    tree = {"w": a["x"], "solve": _jax_state(a, it=7)}
    if writer == "jax":
        jstore.save_checkpoint(str(tmp_path), 7, tree, {"note": "j"})
        got, step, meta = restore_checkpoint(
            str(tmp_path), {"w": np.zeros_like(a["x"]),
                            "solve": T.solve_state_template(a["x"])})
    else:
        save_checkpoint(str(tmp_path), 7,
                        {"w": torch.from_numpy(a["x"]),
                         "solve": _torch_state(a, it=7)}, {"note": "j"})
        tmpl = {"w": np.zeros_like(a["x"]),
                "solve": jkrr.solve_state_template(jnp.asarray(a["x"]))}
        got, step, meta = jstore.restore_checkpoint(str(tmp_path), tmpl)
    assert step == 7 and meta["note"] == "j"
    np.testing.assert_array_equal(got["w"], a["x"])
    for name, v in a.items():
        np.testing.assert_array_equal(np.asarray(getattr(got["solve"], name)),
                                      v)
    assert int(got["solve"].it) == 7


def test_restore_rejects_wrong_shape_and_missing_key(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": np.zeros((4,), np.float32)})
    with pytest.raises(KeyError, match="b"):
        restore_checkpoint(str(tmp_path), {"b": np.zeros((3,), np.float32)})


def test_killed_writer_tmp_stays_invisible(tmp_path):
    """A save killed between the array write and the rename leaves a full
    ``step_N.tmp`` that neither package's ``latest_step`` sees; the
    manager's garbage collection sweeps it once stale."""
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": np.ones((2,), np.float32)})
    with killed_checkpoint_writer():
        with pytest.raises(FaultInjected):
            save_checkpoint(d, 2, {"a": np.ones((2,), np.float32)})
    assert os.path.exists(os.path.join(d, "step_2.tmp", "arrays.npz"))
    assert latest_step(d) == 1 and jstore.latest_step(d) == 1
    mgr = CheckpointManager(d, keep=3)
    mgr.STALE_TMP_SECONDS = -1.0
    mgr._gc()
    assert not os.path.exists(os.path.join(d, "step_2.tmp"))


def test_manager_async_save_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        mgr.save(step, {"v": torch.full((3,), float(step))})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    got, step, _ = restore_checkpoint(str(tmp_path),
                                      {"v": np.zeros((3,), np.float32)})
    assert step == 4 and got["v"].tolist() == [4.0, 4.0, 4.0]


def _fit_case():
    key = jax.random.PRNGKey(4)
    n, d, m = 200, 3, 16
    x = np.asarray(jax.random.uniform(key, (n, d)) * 2.0)
    y = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    return key, x, y, m


def test_preempted_fit_resumes_to_the_uninterrupted_fit(tmp_path):
    """A port fit preempted after its first persisted chunk, run again with
    the same ``solve_checkpoint_dir``, ends bitwise on the uninterrupted
    fit (the state round-trips npz bitwise)."""
    _, x, y, _ = _fit_case()
    lsh = T.sample_lsh_params(np.random.default_rng(5), 16, 3, T.GammaPDF(),
                              device="cpu")
    spec = T.WLSHKernelSpec(bucket=T.RECT)
    kw = dict(lam=0.5, maxiter=60, tol=1e-7, device="cpu")
    d = str(tmp_path / "solve")
    with pytest.raises(FaultInjected):
        T.wlsh_krr_fit(lsh, x, y, spec, solve_checkpoint_dir=d,
                       solve_checkpoint_every=4,
                       on_solve_checkpoint=preempt_after(2), **kw)
    assert latest_step(d) == 8
    seen = []
    resumed = T.wlsh_krr_fit(lsh, x, y, spec, solve_checkpoint_dir=d,
                             solve_checkpoint_every=4,
                             on_solve_checkpoint=lambda st: seen.append(
                                 st.it), **kw)
    whole = T.wlsh_krr_fit(lsh, x, y, spec, **kw)
    assert seen[0] == 12                  # resumed at 8, not from 0
    assert torch.equal(resumed.beta, whole.beta)
    assert torch.equal(resumed.tables, whole.tables)


def test_fit_resumes_from_a_jax_written_state(tmp_path):
    """The JAX package's fit, preempted after a persisted chunk, resumes in
    the port from the state on disk and converges to the JAX package's
    uninterrupted fit: predictions within 1e-5 (both converge to tol
    1e-7; the two sum the matvec in another order)."""
    key, x, y, m = _fit_case()
    d = str(tmp_path / "solve")
    spec = JSpec(bucket=jget("rect"))
    with pytest.raises(JFaultInjected):
        jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y, spec, m=m,
                          lam=0.5, maxiter=200, tol=1e-7,
                          backend="reference", solve_checkpoint_dir=d,
                          solve_checkpoint_every=5,
                          on_solve_checkpoint=jfaults.preempt_after(1))
    assert latest_step(d) == 5
    jm = jkrr.wlsh_krr_fit(jax.random.fold_in(key, 2), x, y, spec, m=m,
                           lam=0.5, maxiter=200, tol=1e-7,
                           backend="reference")
    lsh = lsh_from_reference(
        jsample(jax.random.fold_in(key, 2), m, 3, JGamma(2.0, 1.0), 1.0),
        "cpu")
    seen = []
    tm = T.wlsh_krr_fit(lsh, x, y, T.WLSHKernelSpec(bucket=T.RECT), lam=0.5,
                        maxiter=200, tol=1e-7, device="cpu",
                        solve_checkpoint_dir=d, solve_checkpoint_every=5,
                        on_solve_checkpoint=lambda st: seen.append(st.it))
    assert seen[0] == 10                  # resumed at the JAX state's 5
    xq = x[:50]
    want = np.asarray(jkrr.wlsh_krr_predict(jm, jnp.asarray(xq)))
    np.testing.assert_allclose(T.wlsh_krr_predict(tm, xq).numpy(), want,
                               atol=1e-5)
