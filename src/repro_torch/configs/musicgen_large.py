"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec tokenizer / codebook-interleaving frontend is a
STUB; ``input_specs`` provides precomputed frame embeddings. The LM head
predicts the 2048-entry codebook.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="musicgen-large",
    family="dense",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="embed",
    notes="audio decoder backbone over EnCodec frames (stub frontend)",
))
