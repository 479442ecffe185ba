"""PyTorch/CUDA port of the space use-case inference stack.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names and imports nothing of it. Every Pallas kernel on a
ported path is a hand-written CUDA kernel for Hopper (``csrc/``), each
beside its plain PyTorch version (``kernels/``).
"""
