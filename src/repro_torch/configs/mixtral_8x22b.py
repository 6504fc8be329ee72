"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from .base import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern=(LayerSpec(kind="attn", window=4096, moe=True),),
    moe=MoESpec(n_experts=8, top_k=2, d_ff=16384),
    rope_theta=1000000.0,
    notes="8 experts top-2, SWA window 4096 -> sub-quadratic, runs long_500k",
)
