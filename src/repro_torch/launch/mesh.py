"""The (data, model) grid of ranks that the distributed step runs on.

The JAX package lays its devices out as a ('data', 'model') mesh; here the
ranks of one ``torch.distributed`` process group take that place, row-major
as the JAX mesh: rank r sits at data index r // model and model index
r % model.  Points (x, y) are split by rows over the data index, the LSH
instances by rows over the model index, as ``shard_map``'s in_specs
P('data', None) and P('model', None) cut them.

A multi-axis data grid (the JAX step's ``data_axes=("pod", "data")``) is
this grid's linear data axis: ranks laid out row-major as (pod, data,
model) sit where ``make_host_mesh`` puts them, at data index
``pod_index * data + data_index``, the JAX package's row-major linear
index over its data axes (``_axes_linear_index``), and the JAX step's
collectives over both data axes are the data group's.  So a (pods, data)
grid is ``make_host_mesh`` over pods x data x model ranks; nothing reads
the pod index apart.  The sharding rules see the grid through
``Mesh.axis_sizes`` (``{"data", "model"}``), where a ``("pod", "data")``
candidate resolves as the linear data axis.  The LM step
(``models.sharded``) uses the same two groups: the data group for the FSDP
gathers of ``embed`` and a batch's rows, the model group for the
column/row-parallel products, the vocab-parallel table and the cross-rank
argmax.

``init_distributed`` joins the process group: from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) when it is set, else as the one rank of a group of one.
NCCL on the card and gloo on the CPU unless ``backend`` names one (gloo
carries CUDA tensors too, staged through the host: several ranks sharing
one card, which NCCL refuses).
"""
from __future__ import annotations

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
    """This rank's place in the (data, model) grid and its two groups."""

    data: int              # ranks along the data axes (point shards)
    model: int             # ranks along the model axis (instance shards)
    data_rank: int         # my linear index along the data axes
    model_rank: int        # my index along model
    data_group: object     # the ranks that share my model index
    model_group: object    # the ranks that share my data index
    device: torch.device

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def axis_sizes(self) -> dict[str, int]:
        """The grid's axis sizes as the sharding rules read them
        (``sharding.spec_for``): one linear data axis and the model axis."""
        return {"data": self.data, "model": self.model}


def make_host_mesh(model_parallel: int = 1, *, device=None,
                   ranks=None) -> Mesh | None:
    """The (world // model_parallel, model_parallel) grid over the ranks of
    the initialised process group, row-major; with ``ranks``, over those
    ranks of the group only (the others get None).  Every rank of the
    process group calls it and creates every group, in the same order
    (``dist.new_group`` is collective)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    world = len(ranks)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"model_parallel={model_parallel}")
    data = world // model_parallel
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
    if me not in ranks:
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(data=data, model=model_parallel, data_rank=di,
                model_rank=mi, data_group=data_group,
                model_group=model_group, device=torch.device(device))


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
