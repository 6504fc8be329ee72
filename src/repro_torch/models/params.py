"""Parameter specs of the LM stack: shape, logical axes and initializer in one
declarative tree of nested dicts whose leaves are ``ParamSpec``s.

The port keeps the JAX package's shapes and scales (``repro.models.params``)
but draws its numbers from an explicit ``torch.Generator``: the same seed
gives other values than ``jax.random``, so tests that compare the two
packages convert the JAX parameters (``repro_torch.convert``).  The logical
axes lay the tree out over a (data, model) grid of ranks: ``axes_tree`` gives
them to ``repro_torch.sharding``, and ``abstract`` the shapes as meta
tensors, so a layout is computed without allocating.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis per dim
    init: str = "normal"           # 'normal' | 'zeros' | 'ones'
    scale: float | None = None     # stddev; None -> 1/sqrt(fan_in = shape[0])

    def initializer(self, generator: torch.Generator, dtype) -> torch.Tensor:
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=dev)
        std = self.scale if self.scale is not None else 1.0 / math.sqrt(
            max(self.shape[0], 1))
        out = torch.empty(self.shape, dtype=dtype, device=dev)
        return out.normal_(0.0, std, generator=generator)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of nested dicts (a ``ParamSpec`` is
    a leaf, not a tuple to descend into); with more trees of the same
    keys, ``fn`` takes the leaves at one path from each."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order; the path reads like JAX's
    ``keystr`` (``['groups']['slot0']['attn']['wq']``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{path}['{k}']")
        return out
    return [(path, tree)]


def init_params(specs: Any, generator: torch.Generator,
                dtype=torch.float32) -> Any:
    """Materialize a ParamSpec tree on the generator's device, drawing the
    leaves in sorted key order, so one seed gives one tree."""
    if isinstance(specs, dict):
        return {k: init_params(specs[k], generator, dtype)
                for k in sorted(specs)}
    return specs.initializer(generator, dtype)


def abstract(specs: Any, dtype=torch.float32) -> Any:
    """The spec tree as meta tensors (shape and dtype, no storage): the
    counterpart of the JAX package's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def axes_tree(specs: Any) -> Any:
    """The logical axes of each spec, as a tree of tuples."""
    return tree_map(lambda s: s.axes, specs)


def stack_specs(spec_tree: Any, n: int) -> Any:
    """Add a leading layer-group dim to every spec; unsharded axis."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (None,) + s.axes, s.init, s.scale),
        spec_tree)


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(specs))
