"""llama-3.2-vision-90b — VLM: text backbone w/ gated cross-attn image layers
every 5th layer. [hf:meta-llama/Llama-3.2-90B-Vision]

Spec: the modality frontend is a STUB — input_specs() provides precomputed
image-patch embeddings (batch, 1024, d_model); only the transformer backbone
is modeled.
"""
from .base import LayerSpec, ModelConfig

_SELF = LayerSpec(kind="attn")
_CROSS = LayerSpec(kind="attn", cross_attn=True)

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS),
    cross_attn_source_len=1024,
    rope_theta=500000.0,
    notes="gated cross-attn image layers every 5th layer; vision tower stubbed",
)
