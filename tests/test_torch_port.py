"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it runs on the card unless the CPU is asked for, and its data
recipe is deterministic."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.backend import on_card, resolve_device
from repro_torch.data import make_regression, make_regression_dataset

SRC = Path(__file__).resolve().parent.parent / "src"

_ISOLATED = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
for m in ("repro_torch.models", "repro_torch.configs",
          "repro_torch.kernels.flash_decode", "repro_torch.launch.serve"):
    assert m in mods, m
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[k] is not None)
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax_or_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35


def test_port_sources_name_no_jax_import():
    """Every file of the port, the package and what runs it on the card
    (``chip_smoke.py``, ``tools/``, the ``examples/torch_*.py``), names no
    import of JAX or of the JAX package."""
    root = SRC.parent
    paths = [*(SRC / "repro_torch").rglob("*.py"), root / "chip_smoke.py",
             *(root / "tools").glob("*.py"),
             *(root / "examples").glob("torch_*.py")]
    assert len(list((root / "examples").glob("torch_*.py"))) == 5
    for path in paths:
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro.", "from repro.",
                    "from repro import"):
            assert bad not in text, (path, bad)


def test_no_device_means_the_card():
    lsh = T.sample_lsh_params(np.random.default_rng(0), 4, 3, T.GammaPDF(),
                              device="cpu")
    if torch.cuda.is_available():
        op = T.make_operator(lsh, T.RECT, 1024)
        assert op.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_operator(lsh, T.RECT, 1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.wlsh_krr_fit(lsh, np.zeros((8, 3), np.float32),
                       np.zeros(8, np.float32),
                       T.WLSHKernelSpec(bucket=T.RECT), lam=1.0)
    assert T.make_operator(lsh, T.RECT, 1024, device="cpu").device.type \
        == "cpu"


def test_device_resolution_rules():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert on_card(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        on_card(torch.zeros(1), torch.zeros(1, device="meta"))


def test_operator_refuses_unported_paths():
    lsh = T.sample_lsh_params(np.random.default_rng(1), 4, 2, T.GammaPDF(),
                              device="cpu")
    op = T.make_operator(lsh, T.RECT, 256, device="cpu")
    feats = op.featurize(np.random.default_rng(2).random((50, 2)))
    # exact mode is ported; a mode neither package has raises
    assert isinstance(op.build_index(feats, mode="exact"), T.ExactIndex)
    with pytest.raises(ValueError):
        op.build_index(feats, mode="sketch")
    idx = op.build_index(feats, blocked=False)
    beta = torch.ones(50)
    full = op.build_index(feats)
    # an index without the layout takes the point scatter and the split
    # matvec; both agree with the layout's paths
    for index in (idx, full):
        torch.testing.assert_close(op.loads(index, beta),
                                   T.table_loads(full, beta))
    torch.testing.assert_close(op.matvec(idx, beta), op.matvec(full, beta))


def test_regression_data_is_seeded_and_standardized():
    a = make_regression(500, 100, 7, rough=0.3, seed=3)
    b = make_regression(500, 100, 7, rough=0.3, seed=3)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
        assert u.dtype == np.float32
    x, y, xq, yq = a
    assert x.shape == (500, 7) and xq.shape == (100, 7) and yq.shape == (100,)
    assert abs(float(y.mean())) < 1e-4 and abs(float(y.std()) - 1) < 1e-3
    assert 0.0 <= float(x.min()) and float(x.max()) <= 2.0
    xs = make_regression_dataset("wine", seed=0, scale=0.05)
    assert xs[0].shape == (200, 11)
