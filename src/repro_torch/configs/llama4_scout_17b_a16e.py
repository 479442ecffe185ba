"""llama4-scout-17b-a16e — MoE 16 experts top-1, early fusion [hf; unverified].

Every layer is MoE (period=1) with one shared expert — this reproduces the
~109B-total / ~17B-active parameter split of the published model.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1, layer_period=1),
    notes="MoE every layer; experts sharded over (data, model) = 256-way EP",
))
