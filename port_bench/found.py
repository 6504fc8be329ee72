"""Files the harness finds by a name in ``BENCHMARK.json`` or in a data
file: a per-layer metric's reader (``metrics/``), a mix's runner
(``kinds/``), a configuration's data recipe (``recipes/``)."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path


def load(bench_dir, folder: str, name: str):
    """The module ``<bench_dir>/<folder>/<name>.py``; raises ``LookupError``
    naming the files there when it is missing."""
    path = Path(bench_dir) / folder / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in path.parent.glob("*.py")
                      if p.stem != "__init__")
        raise LookupError(f"port_bench: no {folder}/{name}.py; have {have}")
    tag = re.sub(r"\W", "_", f"{folder}.{name}")
    spec = importlib.util.spec_from_file_location(f"port_bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
