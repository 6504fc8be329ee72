"""Step-function builders for the server: the port of the prefill and
decode builders of ``repro.launch.steps``."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import model


def make_prefill_step(cfg: ModelConfig, max_cache_len: int = 0,
                      dtype=torch.bfloat16):
    """(params, batch) -> (last-token logits, cache, pos)."""
    def step(params, batch):
        return model.prefill(cfg, params, batch, max_cache_len=max_cache_len,
                             dtype=dtype)
    return step


def make_decode_step(cfg: ModelConfig, dtype=torch.bfloat16):
    """(params, cache, tokens (B,1), pos (B,)) -> (logits, cache); the cache
    is updated in place."""
    def step(params, cache, tokens, pos):
        return model.decode_step(cfg, params, cache, tokens, pos, dtype=dtype)
    return step
