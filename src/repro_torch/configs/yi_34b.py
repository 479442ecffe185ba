"""yi-34b — llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    notes="llama-arch GQA; 56 q heads pad to 64 for TP=16 (see parallel/sharding.py)",
))
