"""zamba2-7b — hybrid: Mamba2 backbone + SHARED attention block. [arXiv:2411.15242]

81 layers, period-3 pattern: (mamba2, mamba2, mamba2 + shared attn).  The
shared attention block has ONE global parameter set reused at all 27
applications (zamba's hallmark).  We window the shared attention (4096) so the
hybrid stays sub-quadratic for long_500k (adaptation noted in DESIGN.md).
"""
from .base import LayerSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=(
        LayerSpec(kind="mamba2"),
        LayerSpec(kind="mamba2"),
        LayerSpec(kind="mamba2", shared_attn=True, window=4096),
    ),
    ssm=SSMSpec(kind="mamba2", state_dim=64, head_dim=64, expand=2, conv_width=4),
    notes="Mamba2 + shared windowed attn blocks (window 4096), ssm_state=64",
)
