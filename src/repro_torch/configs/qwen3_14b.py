"""qwen3-14b — dense, qk_norm, GQA kv=8. [hf:Qwen/Qwen3-14B]

40 heads is NOT divisible by the 16-way model axis: the sharding rules engine
falls back (heads unsharded in compute; head_dim sharded for param storage) —
see ``repro_torch.sharding`` and DESIGN.md §6.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    layer_pattern=(LayerSpec(kind="attn"),),
    use_qk_norm=True,
    rope_theta=1000000.0,
    notes="qk_norm, GQA kv=8",
)
