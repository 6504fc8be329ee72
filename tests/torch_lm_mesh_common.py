"""Helpers shared by the LM grid tests (``test_torch_lm_mesh.py``, the
dense archs, and ``test_torch_lm_mesh_slots.py``, the other slots): the
seeded numpy parameters, the case names, the per-rank walk of a grid's
results and each rank's blocks by the JAX package's specs."""
import math

import numpy as np
import torch

from repro.models import model as JM
from repro.sharding import spec_for as jax_spec_for
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.models.params import tree_map
from repro_torch.testing.train import fan_in_scale


class FakeMesh:
    """Duck-typed JAX mesh: axis_names + devices.shape is all spec_for
    reads."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


def np_params(cfg, rng: np.random.Generator):
    """Float32 parameters of ``cfg`` drawn from ``rng`` at std
    1/sqrt(fan-in)."""
    def draw(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        std = s.scale if s.scale is not None else 1 / math.sqrt(s.shape[0])
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    return tree_map(lambda a: a.astype(np.float32),
                    fan_in_scale(cfg, tree_map(draw, TM.param_specs(cfg))))


def batches(grid):
    return (4, 3) if grid[0] == 2 else (4,)


def case_name(name, b):
    return f"{name} B={b}"


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def each_case(grid):
    """(case name, rank result, that rank's case) for every rank."""
    for r in grid[1]:
        for name, c in r["cases"].items():
            yield name, r, c


def _jax_block(a: np.ndarray, spec, sizes, rank: dict) -> np.ndarray:
    """A rank's block of ``a`` by a JAX PartitionSpec, cut here."""
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        parts = math.prod(sizes[n] for n in names)
        idx = 0
        for n in names:                 # row-major over the named axes
            idx = idx * sizes[n] + rank[n]
        step = a.shape[i] // parts
        a = a[(slice(None),) * i + (slice(idx * step, (idx + 1) * step),)]
    return a


def jax_blocks(jcfg, params, sizes, rank):
    """Every leaf's block by the JAX package's param axes and spec_for."""
    axes = JM.param_axes(jcfg)
    mesh = FakeMesh(sizes)

    def walk(p, ax):
        if isinstance(p, dict):
            return {k: walk(p[k], ax[k]) for k in p}
        return _jax_block(np.asarray(p), jax_spec_for(ax, p.shape, mesh),
                          sizes, rank)
    return walk(params, axes)


def fake_mesh(d, m, di, mi):
    """A (d, m) grid's ``Mesh`` as rank (di, mi) sees it, without groups."""
    return Mesh(data=d, model=m, data_rank=di, model_rank=mi,
                data_group=None, model_group=None,
                device=torch.device("cpu"))
