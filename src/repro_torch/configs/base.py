"""Configuration system for repro_torch.

Two config families live here:

* :class:`ArchConfig` — the ten assigned LM-family architectures (dense /
  MoE / SSM / hybrid / VLM / audio backbones), selectable via ``--arch``.
* :class:`ShapeSpec` — the per-arch input-shape cells (train_4k,
  prefill_32k, decode_32k, long_500k).

Configs are plain frozen dataclasses so they hash, print, and diff well;
the registry maps ``arch_id -> ArchConfig`` and is populated by the
``repro_torch.configs.<arch>`` modules at import time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (llama4-style top-1 routing)."""

    num_experts: int
    top_k: int = 1
    num_shared_experts: int = 1
    # Every `period`-th layer is MoE (1 = every layer, 2 = alternating).
    layer_period: int = 1
    capacity_factor: float = 1.25
    # Expert-parallel dispatch implementation:
    #   'scatter' — sharded capacity-buffer scatter (XLA SPMD resolves the
    #               cross-shard writes; baseline — measured collective-bound)
    #   'a2a'     — shard_map + explicit all_to_all over the 'model' axis
    #               (§Perf iteration A1; tokens move, not buffers)
    ep_impl: str = "scatter"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    state_dim: int = 128          # N — SSM state size per head
    head_dim: int = 64            # P — channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4           # short causal conv kernel
    chunk_size: int = 256         # SSD block size for the chunked scan


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture.

    ``family`` selects the block stack:
      dense   — pre-norm GQA transformer (llama-style)
      moe     — dense attention + routed expert FFN
      ssm     — attention-free Mamba2 (SSD) stack
      hybrid  — Mamba2 stack with a *shared* (weight-tied) attention block
                applied every ``hybrid_attn_period`` layers (zamba2-style)

    ``frontend`` selects what ``input_specs`` feeds the backbone:
      text    — int32 token ids, embedding table lookup
      embed   — precomputed frame/patch embeddings (the modality frontend
                is a STUB per the assignment; vlm + audio archs)
    """

    arch_id: str
    family: str                       # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int                    # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    frontend: str = "text"            # text | embed
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 6       # hybrid: shared attn every N layers
    tie_embeddings: bool = False
    # Sub-quadratic sequence mixing? Gates the long_500k cell.
    subquadratic: bool = False
    # INT8 KV cache (codes + per-token-head scales) — §Perf B2/C2; the
    # paper's PTQ residency idea applied to the decode-dominating bytes.
    kv_quant: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived sizes ------------------------------------------------------

    @property
    def attends(self) -> bool:
        return self.family in ("dense", "moe") or (
            self.family == "hybrid" and self.hybrid_attn_period > 0
        )

    def num_attn_layers(self) -> int:
        if self.family in ("dense", "moe"):
            return self.num_layers
        if self.family == "hybrid":
            return self.num_layers // self.hybrid_attn_period
        return 0

    def num_moe_layers(self) -> int:
        if self.moe is None:
            return 0
        return self.num_layers // self.moe.layer_period

    def param_count(self) -> int:
        """Analytic parameter count (excludes padding; used for 6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += v * d
        if not self.tie_embeddings:
            n += v * d
        for layer in range(self.num_layers):
            if self.family in ("dense", "moe"):
                n += self._attn_params(d, hd)
                n += 2 * d  # two RMSNorm scales
                if self.moe is not None and layer % self.moe.layer_period == 0:
                    n += self.moe.num_experts * 3 * d * f
                    n += self.moe.num_shared_experts * 3 * d * f
                    n += d * self.moe.num_experts  # router
                else:
                    n += 3 * d * f  # SwiGLU
            elif self.family in ("ssm", "hybrid"):
                n += self._ssm_params(d)
                n += d  # norm
        if self.family == "hybrid":
            # one weight-tied attention block (norm + attn + mlp)
            n += self._attn_params(d, hd) + 3 * d * f + 2 * d
        n += d  # final norm
        return n

    def _attn_params(self, d: int, hd: int) -> int:
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _ssm_params(self, d: int) -> int:
        s = self.ssm
        di = s.expand * d
        nheads = di // s.head_dim
        in_proj = d * (2 * di + 2 * s.state_dim + nheads)
        conv = (di + 2 * s.state_dim) * s.conv_width
        out = di * d + di  # out proj + gate norm
        extra = 2 * nheads  # A_log, dt_bias
        return in_proj + conv + out + extra

    def active_param_count(self) -> int:
        """Active params per token (MoE discounts non-routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive_experts = m.num_experts - m.top_k
        per_layer_inactive = inactive_experts * 3 * self.d_model * self.d_ff
        return self.param_count() - self.num_moe_layers() * per_layer_inactive


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape × step-kind) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ArchConfig) -> Sequence[ShapeSpec]:
    """The shape cells that apply to an arch.

    ``long_500k`` needs sub-quadratic sequence mixing: it runs only for the
    SSM / hybrid archs; full-attention archs skip it (recorded in
    DESIGN.md / EXPERIMENTS.md, not silently).
    """
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch_id {cfg.arch_id!r}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        ) from None


def all_archs() -> Sequence[str]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    # Import the per-arch modules lazily so `import repro_torch.configs.base`
    # never pulls jax.
    if _REGISTRY:
        return
    from repro_torch.configs import arch_defs  # noqa: F401  (registers everything)


def reduced(cfg: ArchConfig, *, layers: int = 2, width: int = 128) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Scales every dimension down while preserving family structure
    (GQA grouping ratio, MoE routing, SSM state, hybrid sharing).
    """
    heads = max(2, min(4, cfg.num_heads)) if cfg.num_heads else 0
    kv = 0
    if heads:
        kv = max(1, min(heads, cfg.num_kv_heads * heads // max(cfg.num_heads, 1)))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(4, cfg.moe.num_experts), layer_period=cfg.moe.layer_period
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk_size=32)
    return dataclasses.replace(
        cfg,
        arch_id=cfg.arch_id + "-smoke",
        num_layers=layers if cfg.family != "hybrid" else max(layers, cfg.hybrid_attn_period),
        d_model=width,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=width // heads if heads else 0,
        d_ff=width * 2,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        hybrid_attn_period=2 if cfg.family == "hybrid" else cfg.hybrid_attn_period,
    )
