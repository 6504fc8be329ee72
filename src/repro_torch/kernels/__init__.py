"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``launch_counts`` reads the launch counter of every kernel wrapper,
``launch_counts_by_shape`` the same counts split by the shape of the
kernel's inputs, and ``reset_launch_counts`` sets them all to 0, so a run
can show that its main path went through the kernels, and at which shapes.
A launch into a CUDA graph is counted when the graph is replayed, not when
it is captured: ``captured_launches`` records it at capture,
``credit_launches`` counts the record at each replay and ``record_tally``
names it.
"""
from __future__ import annotations

from ._build import captured_launches, credit_launches
from .binning.kernel import (bin_fused_matvec_cuda, bin_gather_blocked_cuda,
                             bin_gather_cuda, bin_readout_cuda,
                             bin_scatter_blocked_cuda, bin_scatter_cuda,
                             route_pack_cuda, route_unpack_cuda)
from .featurize.kernel import featurize_cuda
from .flash_decode.kernel import flash_decode_cuda

KERNEL_WRAPPERS = {
    "featurize": featurize_cuda,
    "bin_fused_matvec": bin_fused_matvec_cuda,
    "bin_scatter_blocked": bin_scatter_blocked_cuda,
    "bin_gather": bin_gather_cuda,
    "bin_readout": bin_readout_cuda,
    "bin_scatter": bin_scatter_cuda,
    "bin_gather_blocked": bin_gather_blocked_cuda,
    "route_pack": route_pack_cuda,
    "route_unpack": route_unpack_cuda,
    "flash_decode": flash_decode_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def launch_counts_by_shape() -> dict[str, dict[tuple, int]]:
    return {name: dict(fn.launches_by_shape)
            for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches, fn.launches_by_shape = 0, {}


def record_tally(record) -> tuple[dict[str, int], dict[str, dict[tuple, int]]]:
    """A ``captured_launches`` record as ({kernel: launches},
    {kernel: {input shape: launches}})."""
    names = {fn: name for name, fn in KERNEL_WRAPPERS.items()}
    counts, shapes = {}, {}
    for fn, shape in record:
        name = names.get(fn, fn.__name__)
        counts[name] = counts.get(name, 0) + 1
        per = shapes.setdefault(name, {})
        per[shape] = per.get(shape, 0) + 1
    return counts, shapes
