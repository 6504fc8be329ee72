"""The import guard: nothing the benchmark loads is JAX or the JAX package
(``repro``), and its reference loads nothing of the program
(``repro_torch``) either.  Top-level names are compared whole: the
port's name begins with the JAX package's."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "repro"}
NOT_IN_REFERENCE = NEVER | {"repro_torch"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    bad = NOT_IN_REFERENCE if "reference" in path.parts else NEVER
    assert not top_level_imports(path) & bad


def loaded_after(code: str) -> list[str]:
    """Top-level names in ``sys.modules`` after running ``code`` in a fresh
    interpreter."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_everything_run_loads_is_clean():
    """run.py's modules, every metric reader and count, the reference and
    the program's entry points, loaded as a run loads them."""
    code = "\n".join([
        "import port_bench.harness as H, port_bench.readings, port_bench._tiny",
        "from pathlib import Path",
        f"b = Path({str(BENCH)!r})",
        "[H.load_metric(b, p.stem) for p in (b / 'metrics').glob('*.py')]",
        "[H.found.load(b, d, p.stem) for d in ('kinds', 'recipes')",
        "    for p in (b / d).glob('*.py')]",
        "import port_bench.counts.fit, port_bench.counts.predict",
        "import repro_torch.core.krr, repro_torch.kernels",
        "import repro_torch.kernels.binning.ops, repro_torch.kernels.featurize.ops",
    ])
    assert not set(loaded_after(code)) & NEVER


def test_reference_loads_no_program():
    assert not set(loaded_after("import port_bench.reference")) & \
        NOT_IN_REFERENCE
