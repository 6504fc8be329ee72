"""The (data, model) grid of ranks that the distributed step runs on.

The JAX package lays its devices out as a ('data', 'model') mesh; here the
ranks of one ``torch.distributed`` process group take that place, row-major
as the JAX mesh: rank r sits at data index r // model and model index
r % model.  Points (x, y) are split by rows over the data index, the LSH
instances by rows over the model index, as ``shard_map``'s in_specs
P('data', None) and P('model', None) cut them.

A multi-axis data grid (the JAX step's ``data_axes=("pod", "data")``):
ranks laid out row-major as (pod, data, model) sit at linear data index
``pod_index * data + data_index``, the JAX package's row-major linear
index over its data axes (``_axes_linear_index``), and the JAX step's
collectives over both data axes are the data group's (``data``,
``data_rank`` and ``data_group`` always span every pod: the KRR step and
the batch's rows use them).  With ``pods`` > 1 (``make_host_mesh(pods=)``)
the grid also has the within-pod data group and the pod group, and the
sharding rules see ``Mesh.axis_sizes`` ``{"pod", "data", "model"}``: a
``("pod", "data")`` entry cuts over the linear data axis, a ``"data"`` entry
(the FSDP rule of ``embed``) within a pod, as the JAX production mesh cuts
them.  With one pod the sizes are ``{"data", "model"}`` and a ``("pod",
"data")`` candidate resolves as the linear data axis.  The LM step
(``models.sharded``) uses the data groups for the FSDP gathers of ``embed``
and a batch's rows, the model group for the column/row-parallel products,
the vocab-parallel table and the cross-rank argmax.

``make_production_mesh`` is rank 0 of the JAX package's production mesh
(16x16, or 2x16x16 with the pod axis) without cards: torch's fake process
group backend stands for the other ranks (collectives return at once) and
the mesh's device is ``meta``, for ``launch.dryrun``.

``init_distributed`` joins the process group: from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) when it is set, else as the one rank of a group of one.
NCCL on the card and gloo on the CPU unless ``backend`` names one (gloo
carries CUDA tensors too, staged through the host: several ranks sharing
one card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import resolve_device


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     backend: str | None = None,
                     timeout_s: float | None = None) -> torch.device:
    """Join the process group (once per process) and return this rank's
    device: ``cuda:LOCAL_RANK`` for the card (None), or the CPU.  Without
    ``torchrun``'s environment and without arguments the group has one
    rank, with a file store in a fresh temporary directory.  ``backend``
    (None: NCCL on the card, gloo on the CPU) names the group's backend;
    ``timeout_s`` bounds a collective's wait (None: the backend's
    default)."""
    dev = resolve_device(device)
    env = os.environ
    if rank is None:
        if "RANK" in env and "WORLD_SIZE" in env:
            rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
            init_method = init_method or "env://"
        else:
            rank, world_size = 0, 1
    if init_method is None:
        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0))
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if backend == "nccl" else {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend,
                                init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return dev


class Mesh(NamedTuple):
    """This rank's place in the (data, model) grid and its groups."""

    data: int              # ranks along the data axes, every pod (points)
    model: int             # ranks along the model axis (instance shards)
    data_rank: int         # my linear index along the data axes
    model_rank: int        # my index along model
    data_group: object     # the ranks that share my model index
    model_group: object    # the ranks that share my pod and data index
    device: torch.device
    pods: int = 1          # the data axes' leading 'pod' axis
    pod_data_group: object = None   # pods > 1: my pod's ranks that share
    #                                 my model index (the 'data' axis)
    pod_group: object = None        # pods > 1: one rank a pod, sharing my
    #                                 in-pod data index and model index

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def axis_sizes(self) -> dict[str, int]:
        """The grid's axis sizes as the sharding rules read them
        (``sharding.spec_for``): the linear data axis and the model axis,
        or with pods the pod, in-pod data and model axes."""
        if self.pods == 1:
            return {"data": self.data, "model": self.model}
        return {"pod": self.pods, "data": self.data // self.pods,
                "model": self.model}


def make_host_mesh(model_parallel: int = 1, *, device=None,
                   ranks=None, pods: int = 1) -> Mesh | None:
    """The (world // model_parallel, model_parallel) grid over the ranks of
    the initialised process group, row-major; with ``ranks``, over those
    ranks of the group only (the others get None).  ``pods`` > 1 cuts its
    data axis into (pod, data), the pod axis leading.  Every rank of the
    process group calls it and creates every group, in the same order
    (``dist.new_group`` is collective)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    world = len(ranks)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"model_parallel={model_parallel}")
    data = world // model_parallel
    if pods < 1 or data % pods:
        raise ValueError(f"{data} data ranks do not split into {pods} pods")
    me = dist.get_rank()
    di, mi = divmod(ranks.index(me), model_parallel) if me in ranks \
        else (-1, -1)
    data_group = model_group = None
    for j in range(model_parallel):
        g = dist.new_group([ranks[i * model_parallel + j]
                            for i in range(data)])
        if j == mi:
            data_group = g
    for i in range(data):
        g = dist.new_group([ranks[i * model_parallel + j]
                            for j in range(model_parallel)])
        if i == di:
            model_group = g
    pod_data_group = pod_group = None
    if pods > 1:
        per = data // pods
        at = lambda p, i, j: ranks[(p * per + i) * model_parallel + j]
        for p in range(pods):
            for j in range(model_parallel):
                g = dist.new_group([at(p, i, j) for i in range(per)])
                if (p, j) == (di // per, mi):
                    pod_data_group = g
        for i in range(per):
            for j in range(model_parallel):
                g = dist.new_group([at(p, i, j) for p in range(pods)])
                if (i, j) == (di % per, mi):
                    pod_group = g
    if me not in ranks:
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(data=data, model=model_parallel, data_rank=di,
                model_rank=mi, data_group=data_group,
                model_group=model_group, device=torch.device(device),
                pods=pods, pod_data_group=pod_data_group,
                pod_group=pod_group)


@contextlib.contextmanager
def fake_grid(*shape: int):
    """Rank 0 of a grid of ``shape`` ((data, model) or (pod, data, model))
    without cards: torch's fake process-group backend (every collective
    returns at once, moving nothing) at the grid's world size, and the
    grid's groups on ``device="meta"``.  Destroys the group on exit;
    refuses to start beside an initialised process group."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake grid needs a process of its own")
    # registers the "fake" backend (torch's testing module: no other
    # public home)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    pods, data, model = (1,) * (3 - len(shape)) + tuple(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=pods * data * model)
    try:
        yield make_host_mesh(model, device="meta", pods=pods)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """Rank 0 of the JAX package's production mesh (``repro.launch.mesh``):
    16x16 = 256 ranks ('data', 'model'), or 2 pods = 512 with a leading
    'pod' axis, as ``fake_grid`` (a context manager yielding the
    ``Mesh``)."""
    return fake_grid(2, 16, 16) if multi_pod else fake_grid(16, 16)


def _part(a, parts: int, index: int):
    n = a.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal shards")
    step = n // parts
    return a[index * step:(index + 1) * step]


def local_lsh(mesh: Mesh, lsh):
    """My instances (rows over the model axis) of global LSH parameters,
    on the mesh's device."""
    return type(lsh)(*(_part(t, mesh.model, mesh.model_rank).to(mesh.device)
                       for t in lsh))


def local_tensor(mesh: Mesh, a) -> torch.Tensor:
    """My rows over the data axis of a global host array (x, y, queries),
    as float32 on the mesh's device."""
    part = _part(np.asarray(a), mesh.data, mesh.data_rank)
    return torch.from_numpy(np.array(part, dtype=np.float32)).to(mesh.device)
