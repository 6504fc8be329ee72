"""Public op: GQA flash decode with (B, H, D) <-> (B, KV, G, D) plumbing,
dispatched on the tensors' device (the CUDA kernel on the card, its meta
twin on meta tensors, the plain version on the CPU)."""
from __future__ import annotations

import torch

from ... import roofline
from ...backend import on_card
from ..meta import flash_decode_cost, flash_decode_meta
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
        launch = flash_decode_meta if qg.is_meta else flash_decode_cuda
        qf, vi = qg.float().contiguous(), valid.to(torch.int32)
        with roofline.kernel("flash_decode", lambda: flash_decode_cost(
                qf, cache_k, cache_v, vi)):
            out = launch(qf, cache_k, cache_v, vi, softcap=softcap)
    else:
        out = flash_decode_ref(qg, cache_k, cache_v, valid, softcap=softcap)
    return out.reshape(b, h, d)
