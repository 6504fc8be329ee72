"""The readers of the program's spans and timers (``pcg_host_us``,
``pcg_wait_us``, ``matvec_host_us``, ``predict_host_us``,
``predict_block_host_us`` and the ``.forest`` names): each is the median
of the program's samples, a fit cell's over its window's iterations alone
(the set-up's warm fit recorded the same names first), a predict cell's
over the buffer; None where the program recorded none.  A traced run of
each cell at the CPU's sizes reports its entries."""
import json
import statistics
import types

import pytest

from port_bench import _tiny, harness

ROOT = _tiny.ROOT
BENCH_DIR = ROOT / "port_bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# (entry, the program's span or timer, samples a fit adds beyond its iters)
FIT_READERS = [("pcg_host_us", "pcg.issue", 0),
               ("pcg_host_us.forest", "pcg.issue", 0),
               ("pcg_wait_us", "pcg.wait", 0),
               ("pcg_wait_us.forest", "pcg.wait", 0),
               ("matvec_host_us", "op.matvec", 1),
               ("matvec_host_us.forest", "op.matvec", 1)]
PREDICT_READERS = [("predict_host_us", "predict"),
                   ("predict_block_host_us", "predict.block")]
ENTRIES = [e for e in BENCH["per_layer"] if e["source"] == "program_span"
           and e["unit"] == "us"]


@pytest.fixture
def plant(monkeypatch):
    """Plants the program's sample buffers: ``plant[name] = [us, ...]``."""
    from repro_torch import obs
    buffers = {}
    monkeypatch.setattr(obs, "span_samples_us",
                        lambda name: list(buffers.get(name, [])))
    return buffers


def _run(*iters):
    return types.SimpleNamespace(fits=[{"iters": i} for i in iters])


def test_entries_are_the_eight_span_readers():
    assert sorted(e["name"] for e in ENTRIES) == sorted(
        [n for n, _, _ in FIT_READERS] + [n for n, _ in PREDICT_READERS])
    for e in ENTRIES:
        assert e["better"] == "lower" and len(e["workloads"]) == 1


@pytest.mark.parametrize("entry,span,extra", FIT_READERS)
def test_fit_reader_takes_the_windows_samples(plant, entry, span, extra):
    warm = [1e6] * (4 + extra)                  # the set-up's fit
    window = [5.0, 1.0, 3.0] + [2.0] * extra + [4.0, 9.0] + [6.0] * extra
    plant[span] = warm + window
    got = harness.load_metric(BENCH_DIR, entry).read(_run(3, 2))
    assert got == statistics.median(window)


@pytest.mark.parametrize("entry,span,extra", FIT_READERS)
def test_fit_reader_is_capped_by_the_buffer(plant, entry, span, extra):
    """Past the 4096 samples the buffer holds, the window reads them all."""
    plant[span] = [7.0, 1.0, 4.0]
    assert harness.load_metric(BENCH_DIR, entry).read(_run(400, 400)) == 4.0


@pytest.mark.parametrize("entry,span", PREDICT_READERS)
def test_predict_reader_takes_the_buffer(plant, entry, span):
    plant[span] = [30.0, 10.0, 20.0, 40.0]
    assert harness.load_metric(BENCH_DIR, entry).read(_run()) == 25.0


@pytest.mark.parametrize("entry", [e["name"] for e in ENTRIES])
def test_reader_is_none_without_samples(plant, entry):
    """A program without the span (the parent of this benchmark's entries)
    or a window without fits: the metric is left out."""
    reader = harness.load_metric(BENCH_DIR, entry)
    assert reader.read(_run(5)) is None         # the program recorded none
    for name, span, _ in FIT_READERS:
        if name == entry:
            plant[span] = [1.0, 2.0]
            assert reader.read(_run()) is None  # a window without fits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reports_its_span_metrics(root, cell):
    res = harness.run_cell(root, cell, 2**31 + 777, 0.2, True, device="cpu")
    assert res["correct"], res["checks"]
    want = {e["name"] for e in ENTRIES if cell in e["workloads"]}
    assert want and want <= set(res["metrics"])
    for name in want:
        assert res["metrics"][name]["value"] > 0
        assert res["metrics"][name]["unit"] == "us"
