"""The port's copy of the ``wlsh_krr`` config equals the JAX package's,
field for field, and its shape cells too."""
import dataclasses

from repro.configs import wlsh_krr as J
from repro_torch.configs import wlsh_krr as T


def test_config_fields_equal_the_jax_config():
    assert [f.name for f in dataclasses.fields(T.WLSHKRRConfig)] == \
        [f.name for f in dataclasses.fields(J.WLSHKRRConfig)]
    assert dataclasses.asdict(T.CONFIG) == dataclasses.asdict(J.CONFIG)
    assert T.KRR_SHAPES == J.KRR_SHAPES


def test_config_imports_no_jax():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(T))
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names}
    mods = {node.module.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module}
    assert not ({"jax", "repro"} & (names | mods))
