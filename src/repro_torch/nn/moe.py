"""Mixture-of-experts FFN (llama4-style top-1 routing + shared expert)
(src/repro/nn/moe.py).

Dispatch is scatter-based: tokens are written into a per-expert capacity
buffer ``[E, C, D]`` (overflow dropped, standard capacity-factor
semantics), expert SwiGLU runs as one batched matmul over the buffer, and
results are gathered back. On one card this is the reference's path too:
its all-to-all dispatch (``ep_impl='a2a'``) needs a mesh, and without one
it takes the scatter.

NB: capacity-based dispatch couples sequences within a global batch — a
routing change in one row can evict another row's token from a full expert
buffer (overflow is dropped to the residual). This is the standard
Switch/GShard semantics; causality holds *within* each sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import dot_f32, swiglu
from repro_torch.nn.params import ParamSpec


def moe_spec(cfg: ArchConfig, dims: Dims) -> dict:
    m = cfg.moe
    d, f, e = dims.d_model, dims.d_ff, m.num_experts
    # a2a dispatch needs F-complete expert weights per model shard; scatter
    # dispatch second-level shards F over the data axis.
    ffn_axis = None if m.ep_impl == "a2a" else "expert_ffn"
    spec = {
        "router": ParamSpec((d, e), ("fsdp", None), scale=0.006),
        "w_gate": ParamSpec((e, d, f), ("expert", None, ffn_axis)),
        "w_up": ParamSpec((e, d, f), ("expert", None, ffn_axis)),
        "w_down": ParamSpec((e, f, d), ("expert", ffn_axis, None)),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        spec["shared"] = {
            "w_gate": ParamSpec((d, fs), ("fsdp", "ffn")),
            "w_up": ParamSpec((d, fs), ("fsdp", "ffn")),
            "w_down": ParamSpec((fs, d), ("ffn", "fsdp")),
        }
    return spec


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    cap = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig, dims: Dims) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]. Top-1 routed + shared expert."""
    return _moe_ffn_scatter(params, x, cfg, dims)


def _shared_expert(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.moe.num_shared_experts:
        return torch.zeros_like(x)
    sp = params["shared"]
    return swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])


def _moe_ffn_scatter(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     dims: Dims) -> torch.Tensor:
    """The capacity-buffer scatter dispatch."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.num_experts
    cap = _capacity(t, cfg)

    xf = x.reshape(t, d)
    logits = dot_f32(xf, params["router"])                      # [T, E]
    # llama4 routes with sigmoid gates on the top-1 expert; argmax takes
    # the first maximum, as the reference's does
    eidx = torch.argmax(logits, dim=-1)                         # [T]
    gate = torch.sigmoid(logits.amax(dim=-1))                   # [T]

    onehot = F.one_hot(eidx, e)                                 # [T, E]
    pos = torch.take_along_dim(torch.cumsum(onehot, dim=0) - 1,
                               eidx[:, None], dim=1)[:, 0]      # [T]
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)

    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((eidx, pos_c), torch.where(keep[:, None], xf, 0),
                   accumulate=True)

    out_buf = swiglu(buf, params["w_gate"], params["w_up"], params["w_down"],
                     gate_f32=True)

    y = out_buf[eidx, pos_c]                                    # [T, D]
    y = y * (keep.float() * gate)[:, None].to(x.dtype)
    y = y.reshape(b, s, d)

    if m.num_shared_experts:
        y = y + _shared_expert(params, x, cfg)
    return y


def aux_load_balance_loss(logits: torch.Tensor, eidx: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary (exposed for the training loop;
    the reference defines it and calls it nowhere)."""
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(eidx.long(), e).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return e * (frac * imp).sum()
