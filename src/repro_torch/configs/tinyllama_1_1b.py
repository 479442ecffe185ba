"""tinyllama-1.1b — llama2-arch small GQA [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    notes="GQA kv=4 < TP=16: kv heads padded to 16 for KV-cache TP sharding",
))
