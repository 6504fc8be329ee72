"""Roofline analysis of the port's eager programs, from a trace of their
aten ops: the counterpart of the JAX package's ``hlo_analysis.py``, which
reads compiled HLO.  It needs no card: a step run on meta tensors (shapes,
no storage) under ``Tracer`` counts what the same step run on the card
would, and a step run on CPU or CUDA tensors under it counts what ran.

``Tracer`` is a ``TorchDispatchMode``.  For every aten op it records:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (a matmul counts 2
  |out| |contraction|, as ``hlo_analysis._dot_flops``), by the dtype of
  the op's first operand; other ops count none, as HLO's non-dot ops.
* **HBM bytes**: the bytes of every tensor operand plus every tensor
  result; views and aliases (``view``, ``transpose``, ``detach``, ...) and
  uninitialized allocations (``empty``) count 0, and an op that writes
  some elements of a tensor in place (``index_put_``, ``scatter_``, ...)
  its other operands and the values it writes.  Eager PyTorch fuses
  nothing, so each op really reads its operands from memory and writes its
  results back: this is eager's honest count, where the JAX analysis
  counts only the top-level ops of a fused program.
* **Peak live bytes**: each new storage an op's results hold is added
  while a Python reference keeps it alive; the peak of that sum over the
  trace is the counterpart of the JAX row's temporaries (the arguments,
  allocated before the trace, are not in it).
* **Collectives**: the ``c10d`` ops by kind, their payload bytes (an
  all-gather's gathered result, the operand of the others) and the size
  and ranks of their group.  Their time takes, for each group, the link
  its ranks span: NVLink within one node of ``GPUS_PER_NODE`` cards,
  InfiniBand across nodes; a group of one rank moves nothing.
* **Host reads** (``aten._local_scalar_dense``: ``int(t)``, ``bool(t)``,
  ``t.item()``) and **data-dependent shapes** (``nonzero``,
  ``masked_select``).  On meta tensors they have no value, so they get a
  stand-in: 0 for a read, the bound a step allocates for a shape (every
  element selected); each is listed with its call site.
* **Kernel credits**: the hand-written kernels run outside the dispatcher
  (their wrappers launch through ``ctypes``, or return meta outputs on meta
  tensors), so each kernel op credits the active trace with its FLOPs and
  the bytes of its bound (``kernel``), alike on the card and on meta.

``repeat`` is the trip-count helper of the per-step Python loops that make
a trace slow (rwkv6's wkv recurrence): outside a meta trace it is exactly
the plain loop; under one it runs the body once and scales its counts by
the trip count, as ``hlo_analysis._called_comps`` scales a while body.
``trips`` does the same for a loop whose steps are alike past the first
(the train step's microbatches).

``Roofline`` turns a trace into the JAX dry run's row, against the H100
SXM constants below (NVIDIA's datasheet figures, not measurements).
"""
from __future__ import annotations

import contextlib
import traceback
import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.autograd.graph import get_gradient_edge
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU datasheet
# (dense rates, no sparsity, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12      # bf16/fp16 tensor cores
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BW = 3.35e12              # HBM3, bytes/s
NVLINK_BW = 450e9             # NVLink 4, bytes/s each direction, in a node
IB_BW = 50e9                  # one 400 Gb/s InfiniBand NIC a GPU, bytes/s
GPUS_PER_NODE = 8             # an HGX H100 node

aten = torch.ops.aten

# collective op -> kind, as sharding.collective_counts names them
_C10D_KINDS = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "alltoall_base_": "all_to_all", "alltoall_": "all_to_all",
    "broadcast_": "broadcast",
}
# allocations that write nothing, and views that schemas do not mark
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._unsafe_view.default,
             aten.lift_fresh.default}
# in-place ops that write some elements of their first operand
_SCATTER_INTO = {aten.index_put_, aten._index_put_impl_, aten.index_add_,
                 aten.index_copy_, aten.scatter_, aten.scatter_add_,
                 aten.scatter_reduce_}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64",
                torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
                torch.int8: "s8", torch.uint8: "u8", torch.uint32: "u32",
                torch.bool: "pred"}

_ACTIVE: list["Tracer"] = []   # the tracers entered, innermost last


def _tensors(x):
    """Every tensor in a (nested) op argument or result."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost frame of the traced program outside this module and
    torch: where a host read or a stand-in came from."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        f = fr.filename.replace("\\", "/")
        if "/torch/" in f or f.endswith("/roofline.py"):
            continue
        return f"{f.rsplit('/src/', 1)[-1]}:{fr.lineno} {fr.name}"
    return "?"


@dataclass
class Trace:
    """What a ``Tracer`` counted (FLOPs, bytes and calls scaled by
    ``repeat``'s trip counts; ``ops`` and ``shapes`` are not)."""

    flops: float = 0.0
    flops_by_dtype: dict = field(default_factory=dict)
    flops_once: float = 0.0          # loop bodies counted once (XLA's
    #                                  cost_analysis counterpart)
    hbm_bytes: float = 0.0
    live_bytes: int = 0
    peak_bytes: int = 0
    collectives: dict = field(default_factory=dict)   # kind -> calls, bytes
    collective_time_s: float = 0.0
    kernels: dict = field(default_factory=dict)       # name -> calls, ...
    host_reads: dict = field(default_factory=dict)    # site -> count
    stand_ins: list = field(default_factory=list)
    ops: Counter = field(default_factory=Counter)     # op name -> calls
    shapes: set = field(default_factory=set)

    @property
    def collective_bytes(self) -> float:
        return float(sum(c["bytes"] for c in self.collectives.values()))

    def summary(self) -> dict:
        """The counts two traces of one program must agree on."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": {k: dict(v) for k, v in
                                sorted(self.collectives.items())},
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "host_reads": sum(self.host_reads.values())}


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has a composite (decomposing) kernel."""
    got = _COMPOSITE.get(func)
    if got is None:
        got = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return got


_KEY_TYPES = (int, float, bool, str, type(None), torch.dtype, torch.device,
              torch.memory_format, torch.layout)


def _key_of(x):
    """A hashable stand-in of an op argument: a meta tensor's metadata, a
    plain value itself; None where there is none (the op is not cached)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            return None
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        parts = tuple(_key_of(e) for e in x)
        return None if any(p is None and e is not None
                           for p, e in zip(parts, x)) else (type(x), parts)
    if isinstance(x, _KEY_TYPES):
        return (type(x), x)
    return None


def _meta_key(func, args, kwargs):
    if func.is_view or func._schema.is_mutable or func.namespace != "aten" \
            or not any(isinstance(t, torch.Tensor) for t in _tensors(args)):
        return None
    key = _key_of(args)
    kw = _key_of(tuple(sorted(kwargs.items())))
    if key is None or kw is None:
        return None
    return func, key, kw


def _out_spec(out):
    """(shape, stride, dtype) of a tensor result, a list of them for a
    tuple of tensors, None for anything else."""
    if isinstance(out, torch.Tensor):
        return tuple(out.shape), out.stride(), out.dtype
    if isinstance(out, tuple) and out and all(
            isinstance(t, torch.Tensor) for t in out):
        return [(tuple(t.shape), t.stride(), t.dtype) for t in out]
    return None


def _empty_meta(shape, stride, dtype):
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _bound(func, args):
    """A data-dependent op on meta operands at its bound, every element
    selected: ``nonzero``, ``masked_select``, or indexing (reading or
    writing) by boolean masks, each mask taken as the int64 indices of all
    its elements.  None for any other op."""
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if x is None or not x.is_meta:
        return None
    if func is aten.nonzero.default:
        return torch.empty((x.numel(), x.ndim), dtype=torch.int64,
                           device="meta")
    if func is aten.masked_select.default:
        n = torch.broadcast_shapes(x.shape, args[1].shape).numel()
        return torch.empty((n,), dtype=x.dtype, device="meta")
    if func not in (aten.index.Tensor, aten.index_put_.default,
                    aten.index_put.default) or not any(
            i is not None and i.dtype in (torch.bool, torch.uint8)
            for i in args[1]):
        return None
    idx = []
    for i in args[1]:
        if i is not None and i.dtype in (torch.bool, torch.uint8):
            idx += [torch.empty((i.numel(),), dtype=torch.int64,
                                device="meta")] * i.ndim
        else:
            idx.append(i)
    return func(x, idx, *args[2:])


def _link_bw(ranks) -> float:
    """The slowest link a group's ranks span."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


class Tracer(TorchDispatchMode):
    """Counts the aten ops run under it into ``self.trace``.  Meta tensors
    get the stand-ins of the module docstring; real ones run as they
    are."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self.scale = 1.0
        self.quiet = 0        # > 0 inside a credited kernel call
        self._groups: dict[int, tuple[int, list[int]]] = {}
        self._meta_out: dict = {}
        self._storages: dict[int, weakref.ref] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- the counts ---------------------------------------------------------

    def _alloc(self, out, args=()) -> None:
        """Track the storages of ``out`` that are new: not an operand's (a
        view, an in-place result) and not tracked already."""
        tr = self.trace
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or (key in self._storages
                               and self._storages[key]() is st):
                continue
            size = st.nbytes()
            tr.live_bytes += size
            tr.peak_bytes = max(tr.peak_bytes, tr.live_bytes)

            def freed(_, size=size, key=key, tr=tr):
                tr.live_bytes -= size
                self._storages.pop(key, None)
            self._storages[key] = weakref.ref(st, freed)

    def _shapes(self, out) -> None:
        for t in _tensors(out):
            self.trace.shapes.add((_DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                                   tuple(t.shape)))

    def _group(self, args):
        from torch.distributed import ProcessGroup, get_process_group_ranks
        for a in args:
            if isinstance(a, torch.ScriptObject):
                pg = ProcessGroup.unbox(a)
                key = id(pg)
                if key not in self._groups:
                    ranks = get_process_group_ranks(pg)
                    self._groups[key] = (len(ranks), ranks)
                return self._groups[key]
        return 1, [0]

    def _collective(self, func, args, out) -> None:
        kind = _C10D_KINDS.get(func._opname)
        if kind is None:
            return
        size, ranks = self._group(args)
        if kind == "all_gather":
            payload = sum(_nbytes(t) for t in _tensors(args[0]))
        else:
            payload = sum(_nbytes(t) for t in _tensors(
                args[1] if func._opname == "alltoall_base_" else args[0]))
        tr, s = self.trace, self.scale
        c = tr.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += s
        c["bytes"] += s * payload
        if size > 1:
            tr.collective_time_s += s * payload / _link_bw(ranks)

    def credit(self, name: str, flops: float, nbytes: float) -> None:
        tr, s = self.trace, self.scale
        k = tr.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
        k["calls"] += s
        k["flops"] += s * flops
        k["bytes"] += s * nbytes
        tr.flops += s * flops
        tr.flops_once += flops
        tr.flops_by_dtype["f32"] = tr.flops_by_dtype.get("f32", 0.0) \
            + s * flops
        tr.hbm_bytes += s * nbytes

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on meta operands a functional op's
        output metadata is a function of theirs alone, so it is computed
        once (torch's meta kernels are mostly Python) and later calls get
        fresh tensors of the same shapes, strides and dtypes."""
        key = _meta_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        spec = self._meta_out.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            ins = {t.untyped_storage()._cdata for t in _tensors(args)}
            # False: an op that returned an operand's storage
            self._meta_out[key] = False if any(
                t.untyped_storage()._cdata in ins for t in _tensors(out)) \
                else _out_spec(out) or False
            return out
        if spec is False:
            return func(*args, **kwargs)
        if isinstance(spec, list):
            return tuple(_empty_meta(*sp) for sp in spec)
        return _empty_meta(*spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tr, s = self.trace, self.scale
        if func is aten._local_scalar_dense.default:     # a host read
            site = _site()
            tr.host_reads[site] = tr.host_reads.get(site, 0) + s
            if not args[0].is_meta:
                return func(*args, **kwargs)
            tr.stand_ins.append({"op": "read", "site": site, "value": 0})
            return False if args[0].dtype == torch.bool else 0
        # a composite op reaches the mode undecomposed where autograd is
        # skipped (inference mode): count the ops it is made of, as a
        # recording run sees them
        if _composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if self.quiet:
            out = func(*args, **kwargs)
            self._alloc(out, (args, kwargs.get("out")))
            self._shapes(out)
            return out
        out = _bound(func, args)
        if out is not None:
            tr.stand_ins.append({"op": func.overloadpacket.__name__,
                                 "site": _site(),
                                 "shape": list(out.shape)})
        else:
            out = self._run(func, args, kwargs)
        tr.ops[func.overloadpacket.__name__] += 1
        self._shapes(out)
        if func.namespace == "c10d":
            self._collective(func, args, out)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            if f:
                first = next(_tensors(args))
                key = _DTYPE_NAMES.get(first.dtype, str(first.dtype))
                tr.flops += s * f
                tr.flops_once += f
                tr.flops_by_dtype[key] = tr.flops_by_dtype.get(key, 0) + s * f
        if packet in _SCATTER_INTO:
            # writes its values into self in place: the other operands read,
            # the values (the largest of them) written; self untouched
            others = [_nbytes(t) for t in _tensors(args[1:])]
            tr.hbm_bytes += s * (sum(others) + max(others, default=0))
        elif not (func.is_view or func in _NO_BYTES):
            nb = sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in _tensors(kwargs.get("out", ()))) + \
                sum(_nbytes(t) for t in _tensors(out))
            tr.hbm_bytes += s * nb
        self._alloc(out, (args, kwargs.get("out")))
        return out


def active() -> Tracer | None:
    """The innermost tracer entered, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class _KernelCall:
    """A credited kernel call: the ops inside allocate (the peak sees
    them) and count nothing else."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __enter__(self):
        self.tracer.quiet += 1

    def __exit__(self, *exc):
        self.tracer.quiet -= 1


_NO_TRACE = contextlib.nullcontext()


def kernel(name: str, cost):
    """Context of one call of the hand-written kernel ``name``: with a
    trace active, credit it with ``cost()`` = (operations, bytes of the
    kernel's bound), and count the ops its wrapper runs (allocations) for
    the peak only; without one, nothing."""
    if not _ACTIVE:
        return _NO_TRACE
    tracer = _ACTIVE[-1]
    if tracer.quiet:
        return _NO_TRACE
    tracer.credit(name, *cost())
    return _KernelCall(tracer)


class _Scaled:
    """Counts scaled by a trip count while entered."""

    def __init__(self, tracer: Tracer, n: int):
        self.tracer, self.n = tracer, n

    def __enter__(self):
        self.outer = self.tracer.scale
        self.tracer.scale = self.outer * self.n

    def __exit__(self, *exc):
        self.tracer.scale = self.outer


def _in_checkpoint_forward() -> bool:
    """Whether the tensors that ops save for the backward now go to a
    non-reentrant ``torch.utils.checkpoint``'s forward, which keeps none of
    them (its recompute in the backward keeps them)."""
    top = torch._C._autograd._top_saved_tensors_default_hooks(False)
    return top is not None and getattr(top[0], "__qualname__", "") \
        .startswith("_checkpoint_hook.")


class _Held:
    """Bytes that a trace holds for the plain loop's other steps: live from
    now until ``release`` (or until nothing refers to it)."""

    def __init__(self, trace: Trace, nbytes: int):
        self.trace, self.nbytes = trace, nbytes
        trace.live_bytes += nbytes
        trace.peak_bytes = max(trace.peak_bytes, trace.live_bytes)

    def shrink(self, nbytes: int) -> None:
        nbytes = min(nbytes, self.nbytes)
        self.trace.live_bytes -= nbytes
        self.nbytes -= nbytes

    def release(self, added: torch.Tensor | None = None) -> None:
        """Taken off; ``added``: after the sum of it and a tensor of its
        size into a new one."""
        tr = self.trace
        if added is not None:
            tr.peak_bytes = max(tr.peak_bytes,
                                tr.live_bytes + _nbytes(added))
        self.shrink(self.nbytes)

    __del__ = release


def _same(t):
    return t


def _step(tracer, body, n_xs, flags, carry, inputs):
    """Step 0 of the loop on leaves of ``carry`` and ``inputs`` (each needing
    its gradient as ``flags`` say), with autograd recording: (leaves,
    outputs, the bytes the step keeps for the backward, the part of them
    that the step allocated).  What it keeps is the storages of the tensors
    its ops save, but the whole inputs' (a step saves a slice of them, which
    each step shares) and its outputs' (a carry out is the next step's carry
    in); where the body is a checkpoint, that is its inputs."""
    leaves = [t.detach().requires_grad_(f)
              for t, f in zip((carry,) + tuple(inputs), flags)]
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved.setdefault(st._cdata, st.nbytes())
        # detached (an op of no count): a saved output that kept its
        # grad_fn would make a cycle through the graph that nothing frees
        with _KernelCall(tracer):
            return t.detach()
    # the hooks keep the step's graph whole under an enclosing checkpoint,
    # whose own hooks would drop the tensors that its backward needs
    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, _same):
        outs = tuple(body(leaves[0], *(x[0] for x in leaves[1:1 + n_xs]),
                          *leaves[1 + n_xs:]))
    for t in leaves[1:] + list(outs):
        saved.pop(t.untyped_storage()._cdata, None)
    keep = sum(saved.values())
    return leaves, outs, keep, \
        keep - saved.get(leaves[0].untyped_storage()._cdata, 0)


class _ScaledBody(torch.autograd.Function):
    """Step 0 of a scaled loop where autograd records: its forward and, in
    the backward pass, its gradient, each counted ``n`` times.  It takes
    the whole per-step inputs ``xs`` (the step's slices are taken inside,
    as each step of the plain loop takes its own); ``n_xs`` of them are
    sliced, the rest (``consts``) passed whole.

    The peak holds what the plain loop keeps for the backward.  The forward
    drops the step's graph and holds n steps' kept bytes (``_step``; step
    0's carry in is live already), as the plain loop keeps every step's
    saved tensors until the backward has passed it; under a checkpoint's
    forward it holds none, as the plain loop's ops keep none there.  The
    backward runs the step again (counted for the peak only: its forward
    was counted where it ran, or where a checkpoint recomputed it) and
    holds the other n - 1 steps' bytes while it differentiates it."""

    @staticmethod
    def forward(ctx, tracer, n, body, n_xs, carry, *inputs):
        ctx.set_materialize_grads(False)
        # every step past the first gets a carry that needs its gradient
        # where a step's inputs need theirs
        flags = [t.requires_grad for t in (carry,) + inputs]
        flags[0] = any(flags)
        with _Scaled(tracer, n):
            _, outs, keep, fresh = _step(tracer, body, n_xs, flags, carry,
                                          inputs)
        ctx.tracer, ctx.n, ctx.n_xs, ctx.body = tracer, n, n_xs, body
        ctx.flags, ctx.keep = flags, keep
        ctx.carry_grad = carry.requires_grad
        ctx.held = _Held(tracer.trace, 0 if _in_checkpoint_forward() else
                         (n - 1) * keep + fresh)
        # saved as autograd saves a function's inputs, so that a checkpoint
        # around the loop recomputes it in the backward as it would the
        # plain loop
        ctx.save_for_backward(carry, *inputs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors           # a checkpoint recomputes here
        tracer, n = ctx.tracer, ctx.n
        ctx.held.release()
        tracer.quiet += 1
        try:
            leaves, outs, _, _ = _step(tracer, ctx.body, ctx.n_xs, ctx.flags,
                                       saved[0], saved[1:])
        finally:
            tracer.quiet -= 1
        held = _Held(tracer.trace, (n - 1) * ctx.keep)
        # a step in the loop's middle gets its carry's gradient from the
        # next step: stand in for it (uninitialized: it is meta) where the
        # loop's final carry has none
        grads = ((torch.empty_like(outs[0]) if grads[0] is None
                  and outs[0].requires_grad else grads[0]),) + grads[1:]
        # differentiated from their graph edges: the plain loop's backward
        # holds no step's outputs
        pairs = [(get_gradient_edge(o), g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        del outs
        want = [t for t in leaves if t.requires_grad]
        sliced = leaves[1:1 + ctx.n_xs]
        got = [None] * len(want)
        if pairs and want:
            # the plain loop's later steps' gradients of each sliced input,
            # summed into one tensor of its size, live while the earlier
            # steps run their backward; its peak is then at step n - 2,
            # with the last step's kept bytes freed.  Step 0's gradient of
            # the input takes the sum's place when it comes, and the
            # engine's add of the two makes a third tensor of the size
            sums = [(_Held(tracer.trace, _nbytes(x)), x)
                    for x in sliced if x.requires_grad]
            held.shrink(min(ctx.keep, sum(h.nbytes for h, _ in sums)))
            hooks = [x.register_hook(lambda g, h=h: h.release(added=g))
                     for h, x in sums]
            with _Scaled(tracer, n):
                got = torch.autograd.grad([o for o, _ in pairs], want,
                                          [g for _, g in pairs],
                                          allow_unused=True)
            for (h, _), hook in zip(sums, hooks):
                h.release()
                hook.remove()
            # the engine adds the n steps' gradients of each sliced input
            # into one, n - 1 adds of it (operands and result)
            for t, g in zip(want, got):
                if g is not None and any(t is x for x in sliced):
                    tracer.trace.hbm_bytes += tracer.scale * (n - 1) * 3 * \
                        _nbytes(g)
        held.release()
        it = iter(got)
        out = tuple(next(it) if t.requires_grad else None for t in leaves)
        return (None, None, None, None,
                out[0] if ctx.carry_grad else None) + out[1:]


def repeat(n: int, body, carry, *xs, consts: tuple = ()):
    """The per-step loop ``for t in range(n): carry, y = body(carry,
    *(x[t] for x in xs), *consts)``: returns (carry, [y_0, ..., y_{n-1}]).

    Outside a trace on meta tensors it is that loop, op for op.  Under one
    (a dry run) the body runs once on step 0 with every count scaled by
    ``n``, and y_1 ... y_{n-1} are uninitialized tensors of y_0's shape, so
    what the caller does with the list (a ``stack``) counts as on the
    plain loop.  Where autograd records, the step's backward is scaled
    too, and the peak holds what the plain loop's steps keep for the
    backward (``_ScaledBody``)."""
    tracer = active()
    if tracer is None or n <= 1 or not carry.is_meta:
        ys = []
        for t in range(n):
            carry, y = body(carry, *(x[t] for x in xs), *consts)
            ys.append(y)
        return carry, ys
    inputs = tuple(xs) + tuple(consts)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (carry,) + inputs):
        carry, y = _ScaledBody.apply(tracer, n, body, len(xs), carry,
                                     *inputs)
    else:
        with _Scaled(tracer, n):
            carry, y = body(carry, *(x[0] for x in xs), *consts)
    rest = torch.empty((n - 1,) + tuple(y.shape), dtype=y.dtype,
                       device=y.device)
    return carry, [y, *rest.unbind(0)]


def trips(n: int, like: torch.Tensor):
    """``range(n)`` for a loop whose steps past the first are alike (the
    same ops on operands of the same shapes, as a microbatch loop's).
    Outside a trace on meta tensors (``like`` is not meta) it is that
    range; under one it yields 0, then 1 with every count of its step
    scaled by n - 1, and stops, as ``repeat`` scales a recurrence.  The
    loop must not break early."""
    tracer = active()
    if tracer is None or n <= 2 or not like.is_meta:
        yield from range(n)
        return
    yield 0
    with _Scaled(tracer, n - 1):
        yield 1


# ---------------------------------------------------------------------------
# trace queries (hlo_analysis.py's, on a Trace)
# ---------------------------------------------------------------------------

def tensor_shapes(trace: Trace) -> set:
    """Every (dtype, dims) of a tensor an op of the trace produced, dtypes
    named as HLO names them ('f32', 'bf16', 's32', ...): whether the program
    materializes a buffer of a shape anywhere."""
    return set(trace.shapes)


def materializes_shape(trace: Trace, dims, dtype: str = "f32") -> bool:
    """True when an op of the trace produced a tensor of exactly this
    (dtype, dims)."""
    return (dtype, tuple(int(d) for d in dims)) in trace.shapes


def count_ops(trace: Trace, opcode: str) -> int:
    """Calls of the aten op ``opcode`` (its overload packet's name, e.g.
    'sort'), with no trip weighting."""
    return trace.ops.get(opcode, 0)


# ---------------------------------------------------------------------------
# the roofline row
# ---------------------------------------------------------------------------

def _peak(dtype_name: str) -> float:
    return PEAK_BF16_FLOPS if dtype_name in ("bf16", "f16") \
        else PEAK_F32_FLOPS


@dataclass
class Roofline:
    """The JAX package's ``Roofline`` on the H100's constants: FLOPs and
    bytes for the whole program (every rank alike: rank 0's times
    ``chips``), the collective payload and time a rank."""

    name: str
    chips: int
    hlo_flops: float                 # whole-program FLOPs (all chips)
    hbm_bytes: float                 # whole-program HBM bytes (all chips)
    collective_bytes: float          # per-chip collective payload bytes
    model_flops: float               # useful 6*N*D (or analog) FLOPs
    bytes_per_device: float = 0.0    # arguments + peak of the trace
    stats: Trace | None = None

    @property
    def t_compute(self) -> float:
        """Each dtype's FLOPs at its peak (bf16 on the tensor cores, the
        rest at the float32 rate)."""
        if self.stats is None:
            return self.hlo_flops / (self.chips * PEAK_BF16_FLOPS)
        return sum(f / _peak(k) for k, f in
                   self.stats.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        if self.stats is None:
            return self.collective_bytes / IB_BW
        return self.stats.collective_time_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_dominant(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_frac(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """model-FLOPs ideal time (bf16 peak) / dominant-term time."""
        ideal = self.model_flops / (self.chips * PEAK_BF16_FLOPS)
        return ideal / self.t_dominant if self.t_dominant else 0.0

    def row(self) -> dict:
        return {
            "name": self.name, "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "bytes_per_device": self.bytes_per_device,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flop_frac": self.useful_flop_frac,
            "roofline_frac": self.roofline_frac,
        }


def analyze_trace(name: str, trace: Trace, *, chips: int,
                  model_flops: float, arg_bytes: int = 0) -> Roofline:
    """A ``Roofline`` from rank 0's trace of an SPMD step (every rank runs
    the same ops on blocks of the same shapes)."""
    return Roofline(name=name, chips=chips, hlo_flops=trace.flops * chips,
                    hbm_bytes=trace.hbm_bytes * chips,
                    collective_bytes=trace.collective_bytes,
                    model_flops=model_flops,
                    bytes_per_device=float(arg_bytes + trace.peak_bytes),
                    stats=trace)


def model_flops_train(n_params: int, tokens: int) -> float:
    """6*N*D for a dense decoder train step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params * tokens


def model_flops_decode(n_params_active: int, batch: int) -> float:
    """2*N per generated token (matmul-dominated decode), times batch."""
    return 2.0 * n_params_active * batch

