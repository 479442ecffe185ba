"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``ops`` for the public API)."""
