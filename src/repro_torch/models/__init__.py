"""The LM stack of the port (serving: prefill and ring-cache decode), laid
out like ``repro.models``."""
from . import attention, layers, model, params
