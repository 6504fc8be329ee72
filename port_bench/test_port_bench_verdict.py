"""The verdict of a run (``correct``) at the CPU's sizes: the port passes;
the control (the reference in bfloat16 in its place) and each fault the
cells can have, planted under the timed path, fail.

The cells run on one card, so no exchange between chips exists to leave
out.  The card's own run is ``test_cell_on_card`` (marked ``gpu``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import _tiny, harness

CELLS = ("fit.wlsh_krr", "predict.wlsh_krr", "fit.forest")
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, program="port", trace=False):
    return harness.run_cell(root, cell, SEED, 0.2, trace, device="cpu",
                            program=program)


@pytest.mark.parametrize("cell", CELLS)
def test_port_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    res = run(root, cell, program="control")
    assert not res["correct"], res["checks"]


def _unchanged_state(monkeypatch):
    from repro_torch.core import krr
    orig = krr.pcg_solve

    def solve(*args, **kw):          # every step returns its state
        kw["maxiter"] = 0
        return orig(*args, **kw)
    monkeypatch.setattr(krr, "pcg_solve", solve)


def _half_instances(monkeypatch):
    import repro_torch.kernels.binning as B
    from repro_torch.kernels.binning import ops

    def matvec(index, beta, *, average=True):
        lay = ops._layout(index)
        out = ops.fused_matvec_ref(lay.slot_lay, lay.coeff_lay,
                                   ops._beta_to_layout(lay, beta),
                                   width=lay.num_tiles * lay.block_t)
        vals = ops._layout_to_points(lay, out)
        return vals[:vals.shape[0] // 2].mean(0)

    def readout(index, tables, *, average=True):
        h = index.slot.shape[0] // 2
        return ops.readout_ref(index.slot[:h], index.coeff[:h], tables[:h],
                               average)
    monkeypatch.setattr(B, "bin_fused_matvec_op", matvec)
    monkeypatch.setattr(B, "bin_readout_op", readout)


def _altered_answer(monkeypatch):
    from repro_torch.core import krr
    fit, predict = krr.wlsh_krr_fit, krr.wlsh_krr_predict

    def bump(t):
        t.view(-1)[t.numel() // 3] += 0.1 * float(t.abs().max())
        return t

    def fit_altered(*args, **kw):
        model = fit(*args, **kw)
        bump(model.beta)
        return model
    monkeypatch.setattr(krr, "wlsh_krr_fit", fit_altered)
    monkeypatch.setattr(krr, "wlsh_krr_predict",
                        lambda *a, **kw: bump(predict(*a, **kw)))


FAULTS = {"unchanged_state": _unchanged_state,
          "half_instances": _half_instances,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
def test_cell_on_card():
    """Every cell for a short window on the card, through run.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in CELLS:
        out = subprocess.run(
            [sys.executable, str(_tiny.BENCH_DIR / "run.py"), "--workload",
             cell, "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
            cwd=_tiny.ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ))
        assert out.returncode == 0, out.stderr[-4000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
