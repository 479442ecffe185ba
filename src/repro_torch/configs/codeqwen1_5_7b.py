"""codeqwen1.5-7b — qwen1.5-arch dense [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="qwen1.5 arch (MHA: kv == q heads); QKV bias",
))
