"""A copy of the benchmark at sizes the CPU holds, for its tests: the
data files as they are, with each configuration's scale and each predict
mix's blocks cut.  The limits are the cells' own."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SCALE = dict(n_points=2048, table_size=1 << 13, m=8)
BLOCKS = dict(block_rows=1024, batch_size=256, checked_every=3)


def make_root(dst) -> Path:
    """A benchmark root under ``dst`` (its ``BENCHMARK.json`` and
    ``port_bench/``) at the CPU's sizes."""
    dst = Path(dst)
    shutil.copytree(BENCH_DIR, dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(SCALE)
        (dst / c["file"]).write_text(json.dumps(cfg))
    for mix in (dst / "port_bench" / "traffic").glob("*.json"):
        traffic = json.loads(mix.read_text())
        if traffic["kind"] == "predict":
            traffic.update(BLOCKS)
            mix.write_text(json.dumps(traffic))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
