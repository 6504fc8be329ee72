"""The port's examples (``examples/torch_*.py``) on the CPU, through their
``main(argv)`` or, for the two that start a launcher, their command lines:
quickstart at its own size with three right-hand sides and the export ->
serve round trip, gp_smoothness with its lengthscale grid and a cut m, and
its selection against the JAX example's on the JAX example's data and
instances, serve_decode at 64 requests, distributed_krr on 2 gloo ranks
and train_lm at 12 steps with two injected failures (both started
together by the tests that read them).  Each example raises with
``--device cuda`` and no card.
"""
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GammaPDF as JGamma, sample_lsh_params as jsample
from repro.core import gaussian_kernel as jgaussian
from repro.core.gp import gp_regression_dataset as jgp_dataset
from repro_torch.convert import lsh_from_reference

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "gp_smoothness", "serve_decode", "distributed_krr",
         "train_lm")


def _load(stem: str):
    """An example file as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(f"example_{stem}",
                                                  EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = {name: _load(f"torch_{name}") for name in NAMES}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The module's tests on two intra-op threads, the process's count
    restored after: beside the other workers of a parallel run a full
    pool oversubscribes the cores (on eight threads in a 6-worker run the
    gp_smoothness fits at m 48 took 158 s, 2.5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def launchers(tmp_path_factory):
    """distributed_krr on 2 gloo ranks and train_lm at 12 steps (failures
    injected at steps 5 and 9), started together, each from the
    repository's root in the environment its example gives it, on one
    thread a process."""
    krr, lm = PORT["distributed_krr"], PORT["train_lm"]
    ckpt = tmp_path_factory.mktemp("train_lm")
    cmds = {"distributed_krr": krr.command("cpu", ranks=2),
            "train_lm": lm.command("cpu", str(ckpt), steps=12, ckpt_every=3,
                                   fail_at=(5, 9))}
    env = dict(krr.child_env(), OMP_NUM_THREADS="1")
    procs = {k: subprocess.Popen(c, env=env, cwd=krr.ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finished(proc, timeout=300.0) -> tuple[int, str]:
    out, _ = proc.communicate(timeout=timeout)
    return proc.returncode, out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: --device cuda runs")
@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(name):
    """``--device cuda`` (every example's default) raises without a card:
    no fallback."""
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT[name].main(["--device", "cuda"])


def test_quickstart_three_rhs_export_and_serve(tmp_path, capsys):
    """At its own size (1200 points, m 400) with two posterior samples in
    the solve: the asserts hold (WLSH within 2x exact KRR's RMSE + 0.05,
    the 256-row round trip bitwise or within 1e-6, the cache replay
    bitwise) and it prints OK."""
    art = str(tmp_path / "art")
    assert PORT["quickstart"].main(["--device", "cpu", "--num-rhs", "3",
                                    "--export", art, "--serve", art]) == 0
    out = capsys.readouterr().out
    exact = float(re.search(r"exact KRR : rmse=([\d.]+)", out).group(1))
    wlsh = float(re.search(r"WLSH KRR  : rmse=([\d.]+)", out).group(1))
    assert wlsh < 2.0 * exact + 0.05
    assert "GP posterior: 2 pathwise samples" in out
    assert re.search(r"round-trip (bitwise|<=1e-6) over 256", out)
    assert out.rstrip().endswith("OK")


def test_gp_smoothness_cut_m(capsys):
    """Both buckets over the lengthscale grid at m 48 on the example's own
    data and instances: finite test RMSEs, each lengthscale from the grid,
    and the example's three lines."""
    gps = PORT["gp_smoothness"]
    cpu = torch.device("cpu")
    draws = {label: gps.numpy_draws(label, pdf, gps.D, cpu)
             for label, _, pdf in gps.BUCKETS}
    results = gps.run(gps.make_data(cpu), draws, m=48, device=cpu)
    for rmse, ell in results.values():
        assert np.isfinite(rmse) and ell in gps.ELLS
    gps.report(results)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len([ln for ln in lines if "test RMSE =" in ln]) == 2
    assert "RMSE change" in lines[-1]


def test_gp_smoothness_selection_matches_the_jax_example():
    """The smooth bucket on the JAX example's data (key 1) with the
    instances its ``wlsh_krr_fit`` draws from the bucket's key at each
    lengthscale (``sample_lsh_params(key, m, d, pdf, ell)``), m cut to 48:
    the port picks the lengthscale the JAX example's own
    ``fit_with_ell_selection`` picks, with the test RMSE within 1e-4
    relative (7.45e-6 measured)."""
    jgps, gps = _load("gp_smoothness"), PORT["gp_smoothness"]
    key = jax.random.PRNGKey(1)
    n_tr, n_val = gps.N_TRAIN, gps.N_VAL
    x, y, f = (np.array(a) for a in jgp_dataset(
        key, jgaussian, n=n_tr + n_val + gps.N_TEST, d=gps.D, noise=0.05))
    split = (x[:n_tr], y[:n_tr], x[n_tr:n_tr + n_val], y[n_tr:n_tr + n_val])
    label, bucket, pdf = gps.BUCKETS[1]
    bkey = jax.random.fold_in(key, len(label))
    jpdf = JGamma(pdf.shape, pdf.scale)
    jmodel, _, jell = jgps.fit_with_ell_selection(
        bkey, *(jnp.asarray(a) for a in split), bucket, jpdf, m=48,
        lam=gps.LAM)
    jpred = np.asarray(jgps.wlsh_krr_predict(jmodel,
                                             jnp.asarray(x[n_tr + n_val:])))
    want = float(np.sqrt(np.mean((jpred - f[n_tr + n_val:]) ** 2)))
    draw = lambda m, ell: lsh_from_reference(jsample(bkey, m, gps.D, jpdf,
                                                     ell), "cpu")
    model, _, ell = gps.fit_with_ell_selection(
        draw, *(torch.from_numpy(a) for a in split), bucket, pdf, m=48,
        lam=gps.LAM, device="cpu")
    pred = gps.wlsh_krr_predict(model, torch.from_numpy(x[n_tr + n_val:]))
    got = float(torch.sqrt(torch.mean(
        (pred - torch.from_numpy(f[n_tr + n_val:])) ** 2)))
    assert ell == jell
    assert abs(got - want) <= 1e-4 * want


def test_serve_decode_64_requests(capsys):
    """64 requests through the batcher: all served, every batched answer
    equal to the predictor's direct path."""
    assert PORT["serve_decode"].main(["--device", "cpu",
                                      "--requests", "64"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] 64 requests in", out)
    err = float(re.search(r"max \|batched - direct\| = (\S+)", out).group(1))
    assert err == 0.0
    assert "health ok=True" in out


def test_distributed_krr_command_is_the_jax_examples():
    """The command is the JAX example's with ``repro_torch`` for ``repro``
    and ``--device`` added (on the CPU behind ``torch.distributed.run``)."""
    jcmd = [a.replace("repro.", "repro_torch.")
            for a in _load("distributed_krr").CMD]
    krr = PORT["distributed_krr"]
    assert krr.command("cuda") == jcmd + ["--device", "cuda"]
    assert krr.command("cpu") == [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "8", *jcmd[1:], "--device", "cpu"]


def test_distributed_krr_on_two_gloo_ranks(launchers):
    """On 2 gloo ranks the launcher exits 0 with a finite test RMSE."""
    rc, out = _finished(launchers["distributed_krr"])
    assert rc == 0, out[-2000:]
    m = re.search(r"on 2 rank\(s\) .* test RMSE ([\d.]+)", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]


def test_train_lm_command_is_the_jax_examples():
    """The command is the JAX example's with ``repro_torch`` for ``repro``,
    a checkpoint directory of the caller's and ``--device`` added."""
    jcmd = [a.replace("repro.", "repro_torch.")
            for a in _load("train_lm").CMD]
    ckpt = jcmd[jcmd.index("--ckpt-dir") + 1]
    assert PORT["train_lm"].command("cuda", ckpt) == jcmd + ["--device",
                                                            "cuda"]


def test_train_lm_resumes_twice(launchers):
    """At 12 steps with failures at steps 5 and 9 the launcher restarts
    twice and exits 0 (its last losses below its first)."""
    rc, out = _finished(launchers["train_lm"])
    assert rc == 0, out[-2000:]
    m = re.search(r"loss ([\d.]+) -> ([\d.]+) \(restarts=(\d+)", out)
    assert m and int(m.group(3)) == 2, out[-2000:]
    assert float(m.group(2)) < float(m.group(1))
