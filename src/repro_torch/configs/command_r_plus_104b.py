"""command-r-plus-104b — dense, GQA kv=8, no biases. [hf:CohereForAI/c4ai-command-r-plus]"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    layer_pattern=(LayerSpec(kind="attn"),),
    rope_theta=75000000.0,
    notes="GQA kv=8, no-bias",
)
