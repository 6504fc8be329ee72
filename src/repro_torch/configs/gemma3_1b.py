"""gemma3-1b — dense, 5:1 local:global attention, 262k vocab, head_dim=256.
[hf:google/gemma-3-1b-pt]

26 layers = 4 x (5 local + 1 global) + 2 local; the pattern is written out
explicitly (period 26, one scan group).  Local window = 512.  Sub-quadratic
for long-context decode except the 4 global layers; long_500k decode reads the
global layers' full cache (O(T) per step) and window-masks the local ones.
"""
from .base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=512)
_GLOBAL = LayerSpec(kind="attn", window=0)
_PATTERN = (tuple([_LOCAL] * 5 + [_GLOBAL]) * 4) + (_LOCAL, _LOCAL)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    layer_pattern=_PATTERN,
    rope_theta=1000000.0,
    tie_embeddings=True,
    notes="5:1 local:global (window 512), 128k context",
)
