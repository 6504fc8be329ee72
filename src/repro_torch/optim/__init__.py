"""The optimizer and gradient compression (the port of ``repro.optim``)."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, \
    cosine_schedule, global_norm, grid_global_norm
from .compression import compressed_psum, dequantize_int8, quantize_int8, \
    stochastic_round_int8
