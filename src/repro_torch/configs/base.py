"""Architecture config dataclasses.

A ``ModelConfig`` fully determines parameters, sharding and step functions.
``layer_pattern`` is a tuple of per-layer ``LayerSpec``s repeated cyclically
(`n_layers % len(layer_pattern) == 0`); heterogeneous stacks (gemma3 5:1
local:global, zamba2 mamba+shared-attn, VLM cross-attn every 5) are expressed
as patterns so the layer stack is one loop over pattern groups.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    kind: str                   # 'mamba2' | 'rwkv6'
    state_dim: int = 64         # N (mamba2) / head_dim (rwkv6)
    head_dim: int = 64
    expand: int = 2             # d_inner = expand * d_model (mamba2)
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"          # 'attn' | 'mamba2' | 'rwkv6'
    window: int = 0             # 0 = global attention; >0 = sliding window
    moe: bool = False           # MoE FFN instead of dense
    cross_attn: bool = False    # cross-attention sublayer (VLM / whisper dec)
    shared_attn: bool = False   # zamba2: run the global shared attn block here


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Whisper-style encoder; the conv/mel frontend is a STUB — inputs are
    precomputed frame embeddings of shape (batch, n_frames, d_model)."""
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    layer_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    encoder: Optional[EncoderSpec] = None
    cross_attn_source_len: int = 0   # image tokens (vlm) / enc frames (audio)
    use_qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}")

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    @property
    def has_shared_attn(self) -> bool:
        return any(s.shared_attn for s in self.layer_pattern)

    @property
    def is_sub_quadratic(self) -> bool:
        """True iff no layer does unbounded-window softmax attention over the
        full sequence (criterion for running the long_500k shape)."""
        for s in self.layer_pattern:
            if s.kind == "attn" and s.window == 0:
                return False
        return True

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
