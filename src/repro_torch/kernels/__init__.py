"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``launch_counts`` reads the launch counter of every kernel wrapper and
``reset_launch_counts`` sets them to 0, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

from .binning.kernel import (bin_fused_matvec_cuda, bin_gather_blocked_cuda,
                             bin_gather_cuda, bin_scatter_blocked_cuda,
                             bin_scatter_cuda, route_pack_cuda,
                             route_unpack_cuda)
from .featurize.kernel import featurize_cuda
from .flash_decode.kernel import flash_decode_cuda

KERNEL_WRAPPERS = {
    "featurize": featurize_cuda,
    "bin_fused_matvec": bin_fused_matvec_cuda,
    "bin_scatter_blocked": bin_scatter_blocked_cuda,
    "bin_gather": bin_gather_cuda,
    "bin_scatter": bin_scatter_cuda,
    "bin_gather_blocked": bin_gather_blocked_cuda,
    "route_pack": route_pack_cuda,
    "route_unpack": route_unpack_cuda,
    "flash_decode": flash_decode_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
