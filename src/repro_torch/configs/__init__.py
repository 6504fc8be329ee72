"""Architecture configs of the LM stack: a copy of the JAX package's
``configs`` (which imports no JAX), kept here so the port imports nothing of
the JAX package.  ``tests/test_torch_lm.py`` holds the two registries equal."""
from .base import EncoderSpec, LayerSpec, ModelConfig, MoESpec, SHAPES, ShapeSpec, SSMSpec
from .registry import ARCH_IDS, CONFIGS, get_config, smoke_config
