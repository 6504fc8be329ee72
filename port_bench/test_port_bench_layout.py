"""The benchmark takes additions as files: a configuration, a mix, a
per-layer metric, a cell, a mix's runner (``kinds/``) and a data recipe
(``recipes/``) added as files and entries run with no edit to a file that
exists.  And ``BENCHMARK.json`` keeps to its format: its keys, names,
units and the files its entries name."""
import filecmp
import json
import re
from pathlib import Path

import pytest

from port_bench import _tiny, found, generate, harness

ROOT = _tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_and_entry_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert e["source"] in SOURCES


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in BENCH["workloads"]] + \
            [w["traffic"] for w in BENCH["workloads"]] + \
            [r for c in BENCH["configs"] for r in c["reduced"]]:
        assert NAME.match(n), n
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for text in [c["source"] for c in BENCH["configs"]] + \
            [x["why"] for k in ("configs", "workloads") for x in BENCH[k]] + \
            [e["layer"] for e in BENCH["per_layer"]] + BENCH["command"]:
        assert LINE.match(text), text


def test_every_entry_has_its_files():
    bench_dir = ROOT / "port_bench"
    cfgs = {c["name"] for c in BENCH["configs"]}
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs
        assert (bench_dir / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench_dir / "limits" / f"{w['name']}.json").is_file()
        reported = {e["name"] for e in harness.metrics_for(
            BENCH["end_to_end"], w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_for(BENCH["per_layer"], w["name"], reported)
    for w in BENCH["workloads"]:
        kind = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                          .read_text())["kind"]
        assert hasattr(found.load(bench_dir, "kinds", kind), "Runner")
    for c in BENCH["configs"]:
        recipe = json.loads((ROOT / c["file"]).read_text())["data"]["recipe"]
        assert hasattr(found.load(bench_dir, "recipes", recipe), "points")
    for e in BENCH["per_layer"]:
        assert e["moves"] in e2e
        assert hasattr(harness.load_metric(bench_dir, e["name"]), "read")


def test_qualified_metric_reads_its_quantity():
    """``pcg_ms.forest`` has no file of its own: ``pcg_ms.py`` reads it."""
    bench_dir = ROOT / "port_bench"
    assert not (bench_dir / "metrics" / "pcg_ms.forest.py").exists()
    assert harness.load_metric(bench_dir, "pcg_ms.forest").__file__ == \
        str(bench_dir / "metrics" / "pcg_ms.py")
    with pytest.raises(LookupError, match="no metrics/nothing_here.py"):
        harness.load_metric(bench_dir, "nothing_here.fit")


def test_unknown_recipe_or_kind_raises(tmp_path):
    cfg = dict(json.loads((ROOT / "port_bench/configs/wlsh_krr.json")
                          .read_text()), n_points=64)
    cfg["data"] = dict(cfg["data"], recipe="no_such_recipe")
    with pytest.raises(LookupError, match="no recipes/no_such_recipe.py"):
        generate.make_inputs(cfg, {"targets": 1}, 3, "cpu")
    with pytest.raises(LookupError, match="no kinds/serve.py"):
        found.load(ROOT / "port_bench", "kinds", "serve")


DUMMY_CFG = dict(json.loads(
    (ROOT / "port_bench/configs/wlsh_krr.json").read_text()),
    name="dummy", n_points=1024, table_size=4096, m=4, dim=6, maxiter=5,
    data={"recipe": "corner", "rough": 0.5, "noise": 0.1})
DUMMY_MIX = {"kind": "fit_reversed", "why": "a mix added as data",
             "targets": 3, "checked_targets": 2}
# a data recipe added as a file: the regression recipe's points, crowded
# into a corner
DUMMY_RECIPE = '''from port_bench.recipes import regression


def points(cfg, rows, g, device):
    cfg = dict(cfg, data=dict(cfg["data"], low=0.0, high=0.5))
    return regression.points(cfg, rows, g, device)


def targets(cfg, x, count, g):
    return regression.targets(cfg, x, count, g)
'''
# a mix's runner added as a file: the fit kind, the targets cycled in the
# reverse order, reporting the fits it made
DUMMY_KIND = '''from pathlib import Path

from port_bench import found

base = found.load(Path(__file__).parent.parent, "kinds", "fit").Runner


class Runner(base):
    def setup(self):
        super().setup()
        self.order = self.order[::-1]
        self.kept_targets = self.order[:len(self.kept_targets)]

    def window(self, seconds):
        out = super().window(seconds)
        out["fits_made"] = len(self.fits)
        return out
'''
DUMMY_METRIC = '''"""dummy_iters: twice the solver's iterations (a reader added as a
file)."""


def read(run):
    return 2.0 * sum(f["iters"] for f in run.fits) / len(run.fits) \\
        if run.fits else None
'''


def test_additions_are_data(tmp_path):
    root = _tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bd = root / "port_bench"
    (bd / "configs" / "dummy.json").write_text(json.dumps(DUMMY_CFG))
    (bd / "traffic" / "dummy_mix.json").write_text(json.dumps(DUMMY_MIX))
    (bd / "kinds" / "fit_reversed.py").write_text(DUMMY_KIND)
    (bd / "recipes" / "corner.py").write_text(DUMMY_RECIPE)
    (bd / "metrics" / "dummy_iters.py").write_text(DUMMY_METRIC)
    (bd / "limits" / "fit.dummy.json").write_text(
        json.dumps({"beta_err": 1e-4, "tables_err": 5e-5}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "port_bench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fit.dummy", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_iters", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "solver", "moves": "fit_s",
                               "workloads": ["fit.dummy"]})
    for e in bench["end_to_end"]:
        if e["name"] == "fit_s":
            e["workloads"].append("fit.dummy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell(root, "fit.dummy", 5, 0.1, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_iters"]["value"] == 10.0
    inputs = generate.make_inputs(DUMMY_CFG, DUMMY_MIX, 5, "cpu",
                                  root / "port_bench")
    assert float(inputs.x.max()) <= 0.5
    res = harness.run_cell(root, "fit.dummy", 5, 0.1, False, device="cpu")
    assert set(res["metrics"]) == {"setup_s", "fit_s"}
    for p, data in before.items():            # nothing that was there moved
        assert p.read_bytes() == data, p
    assert filecmp.cmp(root / "port_bench" / "harness.py",
                       ROOT / "port_bench" / "harness.py", shallow=False)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_read_their_own_files(workload):
    cell, cfg_entry = harness.cell_of(BENCH, workload)
    assert Path(ROOT / cfg_entry["file"]).is_file()
