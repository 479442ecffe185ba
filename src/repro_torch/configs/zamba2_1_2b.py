"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

Mamba2 trunk with ONE weight-tied attention+MLP block applied every
``hybrid_attn_period`` layers (zamba2's shared-block design: the same
attention weights are reused at each application point).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    hybrid_attn_period=6,
    subquadratic=True,
    tie_embeddings=True,
    notes="shared attn every 6 layers (6 applications over 38 layers); "
          "runs long_500k (attention is O(S) per decode step, SSM is O(1))",
))
