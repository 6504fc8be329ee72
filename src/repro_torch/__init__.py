"""PyTorch/CUDA port of the WLSH kernel-ridge-regression system.

Laid out like the JAX package ``repro`` and tested against it; it imports
neither JAX nor anything of ``repro``.  Every hot function has a hand-written
CUDA kernel for Hopper (``csrc/``) beside a plain PyTorch version that the
CPU runs.
"""
