"""Plain PyTorch version of the flash-decode kernel: masked softmax over the
whole cache, the counterpart of ``repro.kernels.flash_decode.ref``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_ref(q, k, v, valid, softcap: float = 0.0):
    """q (B, KV, G, D); k, v (B, T, KV, D); valid (B, T) (> 0 = the row
    holds a real key).  -> (B, KV, G, D) float32.  ``softcap`` > 0 caps the
    scores as ``cap * tanh(s / cap)`` before the mask (0 = off)."""
    d = q.shape[-1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) / (d ** 0.5)
    if softcap and softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None, None, :] > 0, s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bkgt,btkd->bkgd", p, v.float())
