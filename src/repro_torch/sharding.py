"""Logical-axis sharding rules with divisibility fallback: the port of
``repro.sharding``, without JAX.

Every parameter, cache leaf and batch input is annotated with *logical* axis
names; ``spec_for`` resolves them to one entry per dim against a mesh's axis
sizes: None (replicated), a mesh axis name, or a tuple of names (the JAX
``PartitionSpec``'s entries, in the same form).  A rule is dropped, and the
decision recorded, when the dim does not divide by the mesh-axis product or
the mesh axis is already taken by another dim of the same tensor: qwen3's 40
heads do not divide by model=16, so ``heads`` falls through and the
``head_dim`` storage rule takes ``model``.

A mesh is anything that gives axis sizes: a dict such as ``{"pod": 2,
"data": 16, "model": 16}`` for a production mesh with no process group, or
the port's ``launch.mesh.Mesh`` (``axis_sizes``: ``{"data", "model"}``, or
with pods ``{"pod", "data", "model"}``).  A one-pod grid has one linear
data axis, so a ``("pod", "data")`` candidate resolves there as
``("data",)``; on a grid with pods, ``"data"`` cuts within a pod and
``("pod", "data")`` over the linear data axis (``spec_axis``).

JAX's ``constrain`` is a hint to GSPMD, and torch has none.  On a live grid
each rank holds its block of every leaf (``local_block``) and the sharded
step (``models.sharded``) places its collectives itself: ``gather_at_use``
all-gathers the dims a layer needs whole, ``reduce_sum`` sums a
row-parallel product's partial results, ``keep_block`` cuts a tensor every
rank holds whole to the rank's block (the layer boundary's ``act_seq``).

Autograd sees them where it records (``torch.is_grad_enabled()``): each is
then a ``torch.autograd.Function`` whose backward is its mathematical
adjoint (the sum over the ranks of <f(x), y> equals that of <x, f^T(y)>):
the all-reduce's is an all-reduce, the all-gather's a reduce-scatter, and
keep-my-block's the block placed in zeros of the whole.  So a backward pass
through the grid's forward, started on each rank from a loss whose sum over
the ranks is the global loss, gives each rank the partial gradient of its
own copy of every leaf; a leaf's gradient is whole once it is summed over
the grid axes its spec does not name (the ranks that hold the same block).
Under ``no_grad`` or ``inference_mode`` (serving) they are the untracked
in-place calls (``all_reduce_``, ``all_gather_dim``).  Every collective,
forward and backward, counts its calls and bytes by kind
(``collective_counts``).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Sequence

import torch
import torch.distributed as dist

# Rule priority order: earlier rules grab mesh axes first.
# logical name -> candidate mesh-axis assignments (each a tuple of mesh axes).
RULES: tuple[tuple[str, tuple[tuple[str, ...], ...]], ...] = (
    ("batch", (("pod", "data"), ("data",))),
    ("act_seq", (("model",),)),                    # sequence parallelism (SP):
    # activations at layer boundaries shard their seq dim over 'model', which
    # shrinks the remat-saved carry stacks 16x; GSPMD re-gathers inside layers
    ("experts", (("model",),)),
    ("vocab", (("model",),)),
    ("mlp", (("model",),)),
    ("heads", (("model",),)),
    # kv_heads/head_dim take 'model' BEFORE seq_shard can: a ring-cache write
    # along a model-sharded seq dim would need the whole layer cache per step;
    # head dims shard the cache just as well and keep the write shard-local.
    ("kv_heads", (("model",),)),
    ("ssm_heads", (("model",),)),
    ("head_dim", (("model",),)),                   # also storage fallback when
    #                                                heads %% model != 0 (qwen3)
    # long-context / decode KV-cache seq dim: the data axes when batch leaves
    # them free (long_500k, batch=1), else 'model' as last resort (whisper
    # kv=20 with head_dim 64 taken, etc.)
    ("seq_shard", (("pod", "data"), ("data",), ("model",))),
    ("embed", (("data",),)),                        # FSDP param sharding
    ("ssm_state", ()),
    ("seq", ()),
    ("frames", ()),
    (None, ()),
)

_RULE_INDEX = {name: i for i, (name, _) in enumerate(RULES)}
_RULE_MAP = dict(RULES)

Entry = str | tuple[str, ...] | None
Spec = tuple[Entry, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a dict mesh or of a ``launch.mesh.Mesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.axis_sizes)


def spec_for(axes: Sequence[str | None], shape: Sequence[int], mesh,
             decisions: list[str] | None = None) -> Spec:
    """Resolve logical axes to one spec entry per dim for one tensor.

    Dims are processed in rule-priority order so higher-priority logical
    axes win contended mesh axes; within a tensor each mesh axis is used at
    most once (a PartitionSpec invariant).  Skipped candidates that fail
    only on divisibility are logged to ``decisions``, as the JAX function
    words them."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {shape} rank mismatch")
    sizes = axis_sizes(mesh)
    assignment: dict[int, tuple[str, ...]] = {}
    used: set[str] = set()
    order = sorted(range(len(axes)),
                   key=lambda i: _RULE_INDEX.get(axes[i], len(RULES)))
    for i in order:
        name = axes[i]
        for cand in _RULE_MAP.get(name, ()):
            cand = tuple(a for a in cand if a in sizes)
            if not cand:
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod <= 1:
                continue
            if any(a in used for a in cand):
                continue
            if shape[i] % prod != 0:
                if decisions is not None:
                    decisions.append(
                        f"skip {name}->{cand}: {shape[i]} % {prod} != 0")
                continue
            assignment[i] = cand
            used.update(cand)
            break
    entries: list[Entry] = []
    for i in range(len(axes)):
        a = assignment.get(i)
        entries.append(None if a is None else a[0] if len(a) == 1 else a)
    return tuple(entries)


def _is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh,
                   decisions: list[str] | None = None) -> Any:
    """Map (axes, shapes) trees of nested dicts to a tree of specs, leaves
    in sorted key order (JAX's flattening order, so a decision log reads
    as the JAX function's).  ``axes_tree`` leaves are tuples of logical
    names; ``shape_tree`` leaves expose ``.shape``."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, tuple(shape_tree.shape), mesh, decisions)
    return {k: tree_shardings(axes_tree[k], shape_tree[k], mesh, decisions)
            for k in sorted(axes_tree)}


def spec_axis(entry: Entry) -> str:
    """The live grid's axis a spec entry cuts over: 'model', 'data', or
    'pod_data' for ('pod', 'data') (the linear data axis; on a one-pod grid
    the same as 'data')."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    if names == ("model",):
        return "model"
    if names == ("data",):
        return "data"
    if names == ("pod", "data"):
        return "pod_data"
    raise ValueError(f"spec entry {entry!r} names no axis of a live grid "
                     f"('data', 'model', or the data axes ('pod', 'data'))")


def entry_parts(entry: Entry, mesh) -> int:
    """How many blocks a spec entry cuts its dim into on ``mesh``."""
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(sizes[a] for a in names if a in sizes)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` (every rank's is the same: each entry divides its dim)."""
    out = []
    for n, e in zip(shape, spec):
        parts = entry_parts(e, mesh)
        if n % parts:
            raise ValueError(f"dim of size {n} does not split into {parts} "
                             f"blocks over {e!r}")
        out.append(n // parts)
    return tuple(out)


def _in_pods(mesh, axis: str) -> bool:
    """Whether ``axis`` of ``mesh`` is one of the axes a grid with pods
    splits its linear data axis into ('data' within a pod, 'pod')."""
    return axis in ("data", "pod") and getattr(mesh, "pods", 1) > 1


def group_of(mesh, axis: str):
    """The process group of ``mesh`` along ``axis`` ('model', 'data',
    'pod' or 'pod_data')."""
    if axis == "model":
        return mesh.model_group
    if _in_pods(mesh, axis):
        return mesh.pod_group if axis == "pod" else mesh.pod_data_group
    return mesh.data_group


def index_of(mesh, axis: str) -> int:
    """This rank's index along ``axis`` of ``mesh``."""
    if axis == "model":
        return mesh.model_rank
    if _in_pods(mesh, axis):
        per = mesh.data // mesh.pods
        return mesh.data_rank // per if axis == "pod" else \
            mesh.data_rank % per
    return mesh.data_rank


def _count_of(mesh, axis: str) -> int:
    if axis == "model":
        return mesh.model
    if _in_pods(mesh, axis):
        return mesh.pods if axis == "pod" else mesh.data // mesh.pods
    return mesh.data


def _dims(spec: Spec, dims) -> list[int]:
    return [i for i in (range(len(spec)) if dims is None else dims)
            if spec[i] is not None]


def local_block(array, spec: Spec, mesh, dims: Sequence[int] | None = None):
    """This rank of a live grid's block of ``array`` (a global host array or
    tensor) laid out by ``spec``: each dim with an entry (of ``dims`` only,
    where given: the others are already this rank's) cut into equal parts,
    this rank's part kept.  A view or a numpy slice, no copy."""
    for i in _dims(spec, dims):
        axis = spec_axis(spec[i])
        count, index = _count_of(mesh, axis), index_of(mesh, axis)
        size = array.shape[i]
        if size % count:
            raise ValueError(f"dim {i} of size {size} does not split into "
                             f"{count} {axis} blocks")
        step = size // count
        array = array[(slice(None),) * i
                      + (slice(index * step, (index + 1) * step),)]
    return array


# ---------------------------------------------------------------------------
# collectives of the sharded step, counted by kind
# ---------------------------------------------------------------------------

_COUNTS: dict[str, list[int]] = {}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def collective_counts() -> dict[str, dict[str, int]]:
    """{kind: {"calls", "bytes"}} since the last reset: ``all_gather``
    counts the bytes of the gathered result, ``all_reduce`` those of the
    summed tensor, ``reduce_scatter`` those of the whole tensor reduced (an
    all-gather's adjoint)."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in _COUNTS.items()}


def _tally(kind: str, nbytes: int) -> None:
    c = _COUNTS.setdefault(kind, [0, 0])
    c[0] += 1
    c[1] += nbytes


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` in place over ``group`` (every size, one rank
    included; a sum unless ``op`` says otherwise); returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    _tally("all_reduce", x.numel() * x.element_size())
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` over ``group``, in rank order, concatenated
    along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim)
    _tally("all_gather", out.numel() * out.element_size())
    return out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, cut into equal blocks along ``dim``:
    this rank's block (rank order), as an all-reduce of a copy and the
    block kept: the same sum on every backend (gloo's reduce-scatter is
    missing or deprecated in some torch versions), for the group's size
    times a reduce-scatter's bytes."""
    n, index = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim] // n
    _tally("reduce_scatter", x.numel() * x.element_size())
    total = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, group=group)
    return total.narrow(dim, index * size, size).contiguous()


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the adjoint is the same sum of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _AllGather(torch.autograd.Function):
    """The group's blocks concatenated along a dim; the adjoint sums the
    gradients over the group and keeps this rank's block
    (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _KeepBlock(torch.autograd.Function):
    """Block ``index`` of ``count`` equal blocks along a dim (no
    communication); the adjoint places the gradient in zeros of the
    whole."""

    @staticmethod
    def forward(ctx, x, dim, count, index):
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split into {count} blocks")
        size = x.shape[dim] // count
        ctx.dim, ctx.shape, ctx.start = dim, x.shape, index * size
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return out, None, None, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``: autograd's all-reduce where it
    records, else the in-place ``all_reduce_`` (serving's call)."""
    if torch.is_grad_enabled():
        return _AllReduce.apply(x, group)
    return all_reduce_(x.contiguous(), group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``all_gather_dim``, with a reduce-scatter for its backward where
    autograd records."""
    if torch.is_grad_enabled():
        return _AllGather.apply(x, dim, group)
    return all_gather_dim(x, dim, group)


def keep_block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x``, a tensor every rank of a group holds
    whole, by ``spec`` (``local_block``); where autograd records, its
    gradient is placed in zeros of the whole."""
    if not torch.is_grad_enabled():
        return local_block(x, spec, mesh)
    for i in _dims(spec, None):
        axis = spec_axis(spec[i])
        x = _KeepBlock.apply(x, i, _count_of(mesh, axis),
                             index_of(mesh, axis))
    return x


def gather_at_use(tensor: torch.Tensor, spec: Spec, dims: Sequence[int],
                  mesh) -> torch.Tensor:
    """``tensor`` (this rank's block) with each of ``dims`` that ``spec``
    shards all-gathered over its group: whole along those dims.  The same
    tensor when none is sharded.  Where autograd records, the gradient is
    reduce-scattered back to the block."""
    for i in _dims(spec, dims):
        tensor = gather_dim(tensor, i, group_of(mesh, spec_axis(spec[i])))
    return tensor


def unnamed_axes(spec: Spec, mesh=None) -> tuple[str, ...]:
    """The live grid's axes ('data', 'model'; with ``mesh``'s pods, 'pod'
    too) that ``spec`` names for no dim: the leaf is replicated over them.
    'pod' and 'data' both unnamed come as one axis, 'pod_data'."""
    named = set()
    for e in spec:
        if e is not None:
            a = spec_axis(e)
            named |= {"pod", "data"} if a == "pod_data" else {a}
    grid = ("pod", "data", "model") if getattr(mesh, "pods", 1) > 1 \
        else ("data", "model")
    axes = [a for a in grid if a not in named]
    if "pod" in axes and "data" in axes:
        axes = ["pod_data"] + [a for a in axes if a not in ("pod", "data")]
    return tuple(axes)

