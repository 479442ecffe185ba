"""llama4-maverick-400b-a17b — MoE 128 experts top-1 [hf; unverified].

Maverick interleaves dense and MoE FFN layers (period=2): 24 MoE layers x
128 experts x ~126M params/expert ≈ 386B routed + dense trunk ≈ 400B total,
~17B active — matching the published parameter split. (With period=1 the
total would be ~790B, contradicting the 400B name; noted in DESIGN.md.)
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=128, top_k=1, num_shared_experts=1, layer_period=2),
    notes="alternating dense/MoE; 128-expert layers need 256-way expert sharding",
))
