"""Runtime dimensions: config sizes padded for the tensor-parallel degree
(src/repro/nn/dims.py).

Head counts / vocab sizes from public configs are not always divisible by
a tensor-parallel degree (yi-34b has 56 q heads, tinyllama 4 kv heads,
internvl2 a 92,553 vocab). They are padded up to the nearest multiple so
every TP-sharded dim splits evenly. With ``tp=1`` (one card) nothing pads.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig


def pad_to_multiple(n: int, m: int) -> int:
    return math.ceil(n / m) * m


@dataclasses.dataclass(frozen=True)
class Dims:
    tp: int                      # model-axis size the padding targets
    num_heads: int               # padded q heads
    num_kv_heads: int            # padded kv heads
    head_dim: int
    vocab: int                   # padded vocab
    d_model: int
    d_ff: int
    # ssm
    d_inner: int = 0
    ssm_heads: int = 0
    conv_dim: int = 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def compute_dims(cfg: ArchConfig, tp: int = 1) -> Dims:
    heads = pad_to_multiple(cfg.num_heads, tp) if cfg.num_heads else 0
    kv = cfg.num_kv_heads
    if kv:
        kv = kv if kv % tp == 0 else pad_to_multiple(kv, tp)
        kv = min(kv, heads)
        # keep grouping integral: q heads must be a multiple of kv heads
        heads = pad_to_multiple(heads, kv)
    d_inner = ssm_heads = conv_dim = 0
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        ssm_heads = d_inner // cfg.ssm.head_dim
        conv_dim = d_inner + 2 * cfg.ssm.state_dim
    return Dims(
        tp=tp,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=cfg.head_dim,
        vocab=pad_to_multiple(cfg.vocab_size, tp),
        d_model=cfg.d_model,
        d_ff=cfg.d_ff,
        d_inner=d_inner,
        ssm_heads=ssm_heads,
        conv_dim=conv_dim,
    )
