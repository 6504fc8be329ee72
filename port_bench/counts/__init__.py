"""Frozen counts of the work each kernel and each whole call needs, from
the configuration's shapes alone (n, d, m, B, the rows of a call, the
iterations of a solve), never from the program's tensors.

Every module here has ``cost(cfg, **shape) -> {"flops": ..., "bytes": ...}``.
Bytes count each input read once and each output written once, for the
work these inputs need: float32 values and int32 slots take 4 bytes.
FLOPs count the float32 operations of the mathematics.
"""
