"""Device resolution for the port.

There is no backend switch: the device of a tensor decides the path.

* ``resolve_device(None)`` is the card (``cuda``).  Without a card it raises;
  the CPU is taken only when the caller asks for it with ``device="cpu"``.
* A kernel wrapper runs its plain PyTorch version for a tensor on the CPU and
  launches its CUDA kernel for a tensor on the card.  Nothing falls back from
  the kernel to the plain version: a build or launch error raises.
* Meta tensors (a dry run, ``launch.dryrun``) take the card's path, with
  each kernel's meta twin (``kernels.meta``) in place of its launch.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device the entry points run on: ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card (kernel path) or every one is
    a meta tensor (the kernel path of a dry run: the kernel's meta twin, see
    ``on_meta``), False when all lie on the CPU (plain path); raises on a
    mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"} or kinds == {"meta"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on one of cuda/cpu, got {kinds}")


def as_tensor(a, device) -> torch.Tensor:
    """``a`` (a tensor or anything numpy reads) as a contiguous float32
    tensor on ``device``; host arrays are copied, never aliased."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
