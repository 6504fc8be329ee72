"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from .base import EncoderSpec, ModelConfig, MoESpec

from . import (command_r_plus_104b, gemma3_1b, llama4_scout_17b_a16e,
               llama_3_2_vision_90b, mixtral_8x22b, phi3_mini_3_8b, qwen3_14b,
               rwkv6_1_6b, whisper_large_v3, zamba2_7b)

_MODULES = (phi3_mini_3_8b, qwen3_14b, gemma3_1b, command_r_plus_104b,
            llama4_scout_17b_a16e, mixtral_8x22b, zamba2_7b, rwkv6_1_6b,
            llama_3_2_vision_90b, whisper_large_v3)

CONFIGS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = tuple(CONFIGS)

# Archs that run the long_500k cell (sub-quadratic or mostly-local attention;
# see DESIGN.md §Arch-applicability for the per-arch rationale and skips).
LONG_CONTEXT_OK = frozenset({
    "gemma3-1b",      # 5:1 local:global; global layers are O(T)-per-step decode
    "mixtral-8x22b",  # SWA window 4096
    "zamba2-7b",      # Mamba2 state + windowed shared attention
    "rwkv6-1.6b",     # O(1) state
})


def runs_shape(arch: str, shape_name: str) -> bool:
    return shape_name != "long_500k" or arch in LONG_CONTEXT_OK


def get_config(name: str) -> ModelConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(CONFIGS)}") from None


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths/depths, tiny vocab; preserves
    the layer pattern structure (local:global, MoE, hybrid, cross-attn)."""
    cfg = get_config(name)
    period = cfg.period
    # keep 1-2 pattern periods; gemma3's explicit 26-pattern is trimmed to 6.
    if period > 8:
        pattern = cfg.layer_pattern[:6]
        n_layers = 6
    else:
        pattern = cfg.layer_pattern
        n_layers = period * min(2, cfg.n_groups)
    kw: dict = dict(
        n_layers=n_layers,
        layer_pattern=pattern,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
    )
    if cfg.moe is not None:
        kw["moe"] = MoESpec(n_experts=4, top_k=cfgg_topk(cfg), d_ff=96)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, head_dim=16,
                                        expand=2, conv_width=4)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderSpec(n_layers=2, n_frames=12)
        kw["cross_attn_source_len"] = 12
    if cfg.cross_attn_source_len and cfg.encoder is None:
        kw["cross_attn_source_len"] = 12
    # shrink windows so local attention is exercised at tiny seq lens
    new_pat = tuple(dataclasses.replace(s, window=4 if s.window else 0)
                    for s in kw["layer_pattern"])
    kw["layer_pattern"] = new_pat
    return cfg.scaled(**kw)


def cfgg_topk(cfg: ModelConfig) -> int:
    return min(cfg.moe.top_k, 2)
