"""llama4-scout-17b-a16e — MoE 16 experts top-1. [hf:meta-llama/Llama-4-Scout-17B-16E]

Early-fusion multimodality is out of scope for the LM backbone cells (text
tokens only); noted in DESIGN.md.  16 experts divide the 16-way model axis
exactly -> expert-parallel sharding.
"""
from .base import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=(LayerSpec(kind="attn", moe=True),),
    moe=MoESpec(n_experts=16, top_k=1, d_ff=8192),
    rope_theta=500000.0,
    notes="MoE 16e top-1; early fusion frontend out of scope (text backbone)",
)
