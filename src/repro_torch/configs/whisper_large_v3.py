"""whisper-large-v3 — encoder-decoder; conv/mel frontend STUB. [arXiv:2212.04356]

input_specs() provides precomputed frame embeddings (batch, 1500, d_model) in
place of the conv frontend.  Decoder: causal self-attn + cross-attn to the
encoder states in every layer.  Sinusoidal positions on both sides (adaptation:
the real decoder uses a 448-entry learned table, too small for the assigned
32k-decode shapes — noted in DESIGN.md).
"""
from .base import EncoderSpec, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    layer_pattern=(LayerSpec(kind="attn", cross_attn=True),),
    encoder=EncoderSpec(n_layers=32, n_frames=1500),
    cross_attn_source_len=1500,
    notes="enc-dec; conv frontend stubbed as precomputed frame embeddings",
)
