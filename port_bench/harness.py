"""One run of one cell: set-up, the measured window, the reference's
verdict, one result line.

Everything a cell is made of is found by name under the benchmark's
folder, so that a cell, configuration, mix or per-layer metric is added
with files and entries alone:

* ``BENCHMARK.json`` at the root: the cell, its configuration's file,
  its metrics;
* ``traffic/<traffic>.json``: the mix, read by ``generate`` and by the
  runner of its ``kind``, ``kinds/<kind>.py``;
* ``recipes/<recipe>.py``: the data recipe a configuration's ``data``
  names;
* ``limits/<workload>.json``: the limit of each number the reference
  compares;
* ``metrics/<metric>.py``: each per-layer metric's reader, ``read(run)``,
  returning a number or None (nothing to read: the metric is left out);
  ``<quantity>.<qualifier>`` without a file of its own is read by
  ``metrics/<quantity>.py``;
* ``counts/<kernel>.py``: the frozen operations and bytes the readers
  divide by;
* ``peaks.json``: the card's published peaks, by its name.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import found, generate, tracing, workloads

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunRecord:
    """What a per-layer metric's reader reads of a traced run."""

    def __init__(self, cfg, kind, traced, runner, launches, peaks):
        self.cfg, self.kind = cfg, kind
        self.fits = runner.fits                   # telemetry of each fit
        self.rows = runner.rows                   # query rows answered
        self.launches = launches                  # counter deltas
        self.kernel_s = traced.get("kernel_s", {})
        self.busy_s = traced.get("busy_s")
        self.window_s = traced.get("window_s")
        self.peaks = peaks                        # None: unknown card
        self.bounds: dict = {}                    # roofline terms, by metric

    @staticmethod
    def count(name: str):
        return importlib.import_module(f"port_bench.counts.{name}")

    def roofline(self, cost: dict, seconds: float, label: str,
                 times: float = 1.0):
        """100 x (the least time ``times`` x ``cost`` could take on this
        card) / ``seconds``, and which of bytes or FLOPs bounds it; None
        without peaks or time."""
        if not self.peaks or not seconds or seconds <= 0 or times <= 0:
            return None
        t_bytes = cost["bytes"] / self.peaks["bytes_per_s"]
        t_flops = cost["flops"] / self.peaks["f32_flops_per_s"]
        bound = max(t_bytes, t_flops) * times
        self.bounds[label] = {
            "bound_by": "bytes" if t_bytes >= t_flops else "flops",
            "bound_s": bound, "device_s": seconds}
        return 100.0 * bound / seconds


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_metric(bench_dir: Path, name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    for ``<quantity>.<qualifier>`` with no file of its own (the same
    quantity in cells that report another end-to-end metric),
    ``metrics/<quantity>.py``."""
    if (Path(bench_dir) / "metrics" / f"{name}.py").is_file() or \
            "." not in name:
        return found.load(bench_dir, "metrics", name)
    return found.load(bench_dir, "metrics", name.rsplit(".", 1)[0])


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cell_of(bench: dict, workload: str):
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg_entry


def metrics_for(entries, workload: str, reported=None):
    """The entries that this cell reports: those that list it, or, with no
    list, those that move an end-to-end metric it reports."""
    out = []
    for e in entries:
        if "workloads" in e:
            if workload in e["workloads"]:
                out.append(e)
        elif reported is None or e.get("moves") in reported:
            out.append(e)
    return out


def peaks_for(bench_dir: Path, kind: str):
    return load_json(bench_dir / "peaks.json")["cards"].get(kind)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", program="port", t_start=None,
             traffic_override=None) -> dict:
    """Run one cell once and return its result (the keys the result line
    prints).  ``program`` names the thing in the timed path: ``port`` (the
    system under test) or ``control``; ``traffic_override`` replaces keys
    of the mix (``readings.py``'s control, whose calls are slower)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    bench_dir = root / "port_bench"
    bench = load_json(root / "BENCHMARK.json")
    cell, cfg_entry = cell_of(bench, workload)
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_override or {})
    limits = load_json(bench_dir / "limits" / f"{workload}.json")
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    runner_cls = found.load(bench_dir, "kinds", traffic["kind"]).Runner
    built = workloads.PROGRAMS[program].build(device)
    inputs = generate.make_inputs(cfg, traffic, seed, device, bench_dir)
    prog = workloads.PROGRAMS[program](cfg, inputs, device)
    runner = runner_cls(cfg, traffic, inputs, prog, device, seed)
    runner.setup()
    setup_s = workloads.sync(device) - t_start

    before = prog.launch_counts()
    with tracing.window_profile(trace, device) as held:
        e2e = runner.window(seconds)
    launches = {k: v - before.get(k, 0)
                for k, v in prog.launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    result = {"correct": False, "attempted": runner.attempted,
              "failed": runner.failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda"
                         else "cpu", "kind": kind, "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    e2e["setup_s"] = setup_s
    if trace:
        traced = tracing.reduce(held.prof) if held.prof is not None else {}
        held.prof = None
        rec = RunRecord(cfg, traffic["kind"], traced, runner, launches,
                        peaks_for(bench_dir, kind))
        reported = {e["name"] for e in metrics_for(bench["end_to_end"],
                                                   workload)}
        for entry in metrics_for(bench["per_layer"], workload, reported):
            value = load_metric(bench_dir, entry["name"]).read(rec)
            if value is not None:
                result["metrics"][entry["name"]] = {"value": value,
                                                    "unit": entry["unit"]}
        result["device"]["busy_s"] = traced.get("busy_s", 0.0)
        result["device"]["window_s"] = traced.get("window_s",
                                                  e2e["window_s"])
        if "breakdown" in traced:
            result["breakdown"] = traced["breakdown"]
        result["rooflines"] = rec.bounds
    else:
        # ``<quantity>.<qualifier>`` (``fit_s.forest``) reports the
        # runner's ``<quantity>`` under a bound of its own
        for entry in metrics_for(bench["end_to_end"], workload):
            quantity = entry["name"].split(".")[0]
            if quantity in e2e:
                result["metrics"][entry["name"]] = {
                    "value": e2e[quantity], "unit": entry["unit"]}

    # the verdict: the program's state goes, then the reference judges
    runner.release()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = runner.check(limits)
    if runner.failed:                 # answers that never came
        checks["failed_calls"] = {"value": runner.failed, "limit": 0}
        result["errors"] = runner.errors
    result["correct"] = workloads.passed(checks)
    result["program"] = program
    result["built"] = built
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]


def main(argv=None, t_start=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the port's "
                                 "benchmark once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    bench = load_json(root / "BENCHMARK.json")
    cell, _ = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: loaded modules the benchmark must not: {bad}",
              file=sys.stderr)
        return 3
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(v):
    """``v`` with each non-finite float as its name (JSON has none)."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v
