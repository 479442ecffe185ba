"""internvl2-26b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821; hf].

Per the assignment, only the transformer BACKBONE (InternLM2-20B-style
decoder) is modeled; the InternViT vision frontend is a STUB —
``input_specs`` provides precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="internvl2-26b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="embed",
    notes="VLM backbone; patch-embedding stub frontend; vocab padded to 92560 "
          "for TP-16 divisibility of the LM head",
))
