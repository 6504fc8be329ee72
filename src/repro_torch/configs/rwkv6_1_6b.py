"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from .base import LayerSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,           # time-mix heads of head_dim 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=(LayerSpec(kind="rwkv6"),),
    ssm=SSMSpec(kind="rwkv6", state_dim=64, head_dim=64),
    notes="Finch: data-dependent decay; O(1) state decode -> runs long_500k",
)
