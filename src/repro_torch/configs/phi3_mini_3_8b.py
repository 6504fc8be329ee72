"""phi3-mini-3.8b — dense, RoPE SwiGLU, MHA (GQA kv=32). [arXiv:2404.14219]"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern=(LayerSpec(kind="attn"),),
    rope_theta=10000.0,
    notes="RoPE SwiGLU GQA(kv=32 == MHA)",
)
