"""LM decoder block — the on-board telemetry-summarisation language model.

One hybrid transformer/SSM decoder block over a fixed telemetry window:
token-wise (``per_position``) dense projections feed a causal GQA
attention head group and a Mamba-2 SSD scan, with residual adds and a
vocab head. The block is built from op-graph nodes, so it compiles through
the same Planned -> Lowered -> Compiled chain as the CNNs: the inspector
puts the QKV/MLP projections on the int8 accel path around flex
``attention``/``ssd`` segments. The graph is the reference's
(src/repro/models/lm.py), node for node.

Two widths:

* :data:`DEFAULT_CONFIG`, the reference's own small block (d_model 32,
  seq_len 32), which the launcher serves;
* :data:`ZAMBA2_1_2B`, the block at the widths of zamba2-1.2b (arXiv
  2411.15242; the repository's src/repro/configs/zamba2_1_2b.py): d_model
  2048, 32 query and 32 KV heads of dim 64, 64 SSD heads of P = 64 (d_inner
  = 2 x 2048) with a single shared B/C group of N = 64, vocab 32000. Depth
  is the graph's one block; ``seq_len`` 2048 is the prompt window.

Graph contract the LM engine (``core/lm.py``) relies on:

* ``emb``'s only consumers are the q/k/v projections, so the requant pass
  can chain int8 straight through the QKV block;
* ``k_heads`` / ``v_heads`` / ``ssm_heads`` / ``b_proj`` / ``dt`` are graph
  outputs: the prefill KV/state capture points;
* ``resid2`` (the pre-head hidden state) is an output: decode feeds it back
  as the next token's input features (the telemetry LM has no discrete
  token embedding table);
* prompts are full fixed-length windows (``seq_len``): the SSD prefill
  state is the scan's final state, valid only when the prompt fills it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.opgraph import Graph
from repro_torch.models.common import batch_synthetic, init_graph_params


class LMConfig(NamedTuple):
    seq_len: int = 32           # fixed prefill window (telemetry frame)
    d_model: int = 32
    n_q_heads: int = 4          # GQA: 2 query heads per KV head
    n_kv_heads: int = 2
    n_ssm_heads: int = 4
    head_p: int = 8             # SSD per-head state rows (H*P = d_model)
    d_state: int = 8            # SSD state cols N
    vocab: int = 16


DEFAULT_CONFIG = LMConfig()

ZAMBA2_1_2B = LMConfig(seq_len=2048, d_model=2048, n_q_heads=32,
                       n_kv_heads=32, n_ssm_heads=64, head_p=64, d_state=64,
                       vocab=32000)

# prefill capture points + serving outputs, in graph-output order
CAPTURE_OUTPUTS = ("k_heads", "v_heads", "ssm_heads", "b_proj", "dt")
SERVE_OUTPUTS = ("head", "resid2")


def build_graph(cfg: LMConfig = DEFAULT_CONFIG) -> Graph:
    s, d = cfg.seq_len, cfg.d_model
    hd = d // cfg.n_q_heads
    dkv = cfg.n_kv_heads * hd
    dssm = cfg.n_ssm_heads * cfg.head_p
    g = Graph("lm_decoder")
    x = g.input("x", (s, d))
    # token embedding stand-in: consumers are q/k/v ONLY (requant chain)
    emb = g.add("dense", [x], name="emb", features=d, per_position=True)
    q = g.add("dense", [emb], name="q_proj", features=d, per_position=True)
    k = g.add("dense", [emb], name="k_proj", features=dkv,
              per_position=True)
    v = g.add("dense", [emb], name="v_proj", features=dkv,
              per_position=True)
    qh = g.add("reshape", [q], name="q_heads",
               shape=(s, cfg.n_q_heads, hd))
    kh = g.add("reshape", [k], name="k_heads",
               shape=(s, cfg.n_kv_heads, hd))
    vh = g.add("reshape", [v], name="v_heads",
               shape=(s, cfg.n_kv_heads, hd))
    att = g.add("attention", [qh, kh, vh], name="attn", causal=True)
    af = g.add("reshape", [att], name="attn_flat", shape=(s, d))
    op = g.add("dense", [af], name="out_proj", features=d,
               per_position=True)
    ao = g.add("relu", [op], name="attn_out")     # fuses into out_proj
    r1 = g.add("add", [ao, x], name="resid1")
    # SSM branch (Mamba-2 SSD): x/B/C/dt projections off the residual
    xb = g.add("dense", [r1], name="ssm_in", features=dssm,
               per_position=True)
    xh = g.add("reshape", [xb], name="ssm_heads",
               shape=(s, cfg.n_ssm_heads, cfg.head_p))
    bp = g.add("dense", [r1], name="b_proj", features=cfg.d_state,
               per_position=True)
    cp = g.add("dense", [r1], name="c_proj", features=cfg.d_state,
               per_position=True)
    dtd = g.add("dense", [r1], name="dt_proj", features=cfg.n_ssm_heads,
                per_position=True)
    dts = g.add("sigmoid", [dtd], name="dt")      # fuses into dt_proj
    ssm = g.add("ssd", [xh, bp, cp, dts], name="ssm")
    sf = g.add("reshape", [ssm], name="ssm_flat", shape=(s, dssm))
    dn = g.add("dense", [sf], name="down_proj", features=d,
               per_position=True)
    r2 = g.add("add", [dn, r1], name="resid2")
    g.add("dense", [r2], name="head", features=cfg.vocab,
          per_position=True)
    g.mark_output(*SERVE_OUTPUTS, *CAPTURE_OUTPUTS)
    return g


def init_params(seed: int, cfg: LMConfig = DEFAULT_CONFIG
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    return init_graph_params(build_graph(cfg), seed)


def synthetic_input(rng: np.random.Generator,
                    cfg: LMConfig = DEFAULT_CONFIG) -> Dict[str, np.ndarray]:
    """One telemetry window: [S, D] continuous features."""
    return {"x": np.float32(0.5) * rng.standard_normal(
        (cfg.seq_len, cfg.d_model), dtype=np.float32)}


def synthetic_batch(rng: np.random.Generator, n: int,
                    cfg: LMConfig = DEFAULT_CONFIG) -> Dict[str, np.ndarray]:
    return batch_synthetic(lambda r: synthetic_input(r, cfg), rng, n)
