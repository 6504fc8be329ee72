"""Public op: GQA flash decode with (B, H, D) <-> (B, KV, G, D) plumbing,
dispatched on the tensors' device (the CUDA kernel on the card, the plain
version on the CPU)."""
from __future__ import annotations

import torch

from ...backend import on_card
from .kernel import flash_decode_cuda
from .ref import flash_decode_ref


def decode_attend_op(q, cache_k, cache_v, valid, softcap: float = 0.0):
    """q (B, H, D); cache_{k,v} (B, T, KV, D); valid (B, T) -> (B, H, D)
    float32.  H must be a multiple of KV (GQA): query head j reads kv head
    j // (H / KV)."""
    b, h, d = q.shape
    kv = cache_k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    qg = q.reshape(b, kv, h // kv, d)
    if on_card(qg, cache_k, cache_v, valid):
        out = flash_decode_cuda(qg.float().contiguous(), cache_k, cache_v,
                                valid.to(torch.int32), softcap=softcap)
    else:
        out = flash_decode_ref(qg, cache_k, cache_v, valid, softcap=softcap)
    return out.reshape(b, h, d)
