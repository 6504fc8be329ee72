"""The LM stack of the port (training, prefill and ring-cache decode of
every registry arch), laid out like ``repro.models``."""
from . import (attention, layers, mamba2, model, moe, params, rwkv6,
               wlsh_attention)
