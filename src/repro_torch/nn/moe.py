"""Mixture-of-experts FFN (llama4-style top-1 routing + shared expert)
(src/repro/nn/moe.py).

Dispatch is scatter-based: tokens are written into a per-expert capacity
buffer ``[E, C, D]`` (overflow dropped, standard capacity-factor
semantics), expert SwiGLU runs as one batched matmul over the buffer, and
results are gathered back. The buffer is the *only* E-indexed activation,
sharded ``('expert' -> model, 'expert_cap' -> data)``. With
``ep_impl='a2a'`` on a mesh whose 'model' axis divides the experts, tokens
move to their experts' ranks instead (:func:`_moe_routed_a2a`); without a
mesh that config takes the scatter too, as the reference's does.

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
from repro_torch.nn.layers import dot_f32, mlp, swiglu_hidden
from repro_torch.nn.params import ParamSpec
from repro_torch.parallel.sharding import (all_to_all_autograd, constrain,
                                           current_mesh, current_rules,
                                           full_on_ranks, shard_map, spec_for)


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
    mesh = current_mesh()
    if (cfg.moe.ep_impl == "a2a" and mesh is not None
            and "model" in mesh.axis_names
            and cfg.moe.num_experts % mesh.shape["model"] == 0):
        y = _moe_routed_a2a(params, x, cfg, mesh)
        return y + _shared_expert(params, x, cfg)
    return _moe_ffn_scatter(params, x, cfg, dims)


def _shared_expert(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.moe.num_shared_experts:
        return torch.zeros_like(x)
    return mlp(params["shared"], x)


def _moe_routed_a2a(params: dict, x: torch.Tensor, cfg: ArchConfig, mesh
                    ) -> torch.Tensor:
    """Expert parallelism with explicit all-to-all over the 'model' axis:
    tokens move (2 x T_local x D per layer over the EP axis) instead of
    expert capacity buffers being reduced.

    Per-rank plan (inside one local region):
      1. route local tokens (router replicated),
      2. pack per-destination-rank send buffers [tp, cap, D] by cumsum
         position (overflow past per-pair capacity dropped, standard
         capacity-factor semantics applied per (src, dst) pair),
      3. all-to-all tokens + local-expert indices,
      4. per-local-expert capacity scatter (LOCAL — no collectives),
         batched expert SwiGLU,
      5. all-to-all results back, unpack to token order, gate at source.
    """
    m = cfg.moe
    tp = mesh.shape["model"]
    e_per = m.num_experts // tp
    rules = current_rules()
    group = mesh.group("model")
    x_spec = spec_for(x.shape, ("batch", "seq", None), mesh, rules)
    w_spec = spec_for(params["w_gate"].shape, ("expert", None, None), mesh,
                      rules)
    wd_spec = spec_for(params["w_down"].shape, ("expert", None, None), mesh,
                       rules)
    r_spec = (None, None)

    def a2a(t):
        return all_to_all_autograd(t.contiguous(), None, None, group)

    def routed(x_blk, router, w_gate, w_up, w_down):
        bl, sl, d = x_blk.shape
        tl = bl * sl
        dev = x_blk.device
        xf = x_blk.reshape(tl, d)
        logits = dot_f32(xf, router)                            # [tl, E]
        eidx = torch.argmax(logits, dim=-1)                     # global expert
        gate = torch.sigmoid(logits.amax(dim=-1))
        dest = eidx // e_per                                    # model rank
        e_loc = eidx % e_per

        cap = max(8, -(-int(tl * m.top_k * m.capacity_factor) // tp) // 8 * 8)
        dest_1h = F.one_hot(dest, tp)                           # [tl, tp]
        pos = torch.take_along_dim(torch.cumsum(dest_1h, dim=0) - 1,
                                   dest[:, None], dim=1)[:, 0]
        keep = pos < cap
        pos_c = torch.where(keep, pos, cap - 1)

        send = torch.zeros((tp, cap, d), dtype=x_blk.dtype, device=dev)
        send = send.index_put((dest, pos_c),
                              torch.where(keep[:, None], xf, 0),
                              accumulate=True)
        send_e = torch.full((tp, cap), e_per, dtype=torch.long, device=dev)
        flat = dest * cap + pos_c                               # pad -> dummy
        send_e = send_e.reshape(-1).scatter_reduce(
            0, flat, torch.where(keep, e_loc, e_per), "amin"
        ).reshape(tp, cap)

        recv = a2a(send)
        recv_e = a2a(send_e.int()).long()
        rt = tp * cap
        tok_in = recv.reshape(rt, d)
        e_in = recv_e.reshape(rt)

        if e_per == 1:
            valid = (e_in == 0)[:, None].to(tok_in.dtype)
            h = swiglu_hidden(tok_in * valid, w_gate[0], w_up[0])
            y_r = h @ w_down[0]
        else:
            # LOCAL capacity scatter over my e_per experts (+1 dummy slot)
            cap2 = max(8, -(-rt // e_per) // 8 * 8)
            oh = F.one_hot(e_in, e_per + 1)
            pos2 = torch.take_along_dim(torch.cumsum(oh, dim=0) - 1,
                                        e_in[:, None], dim=1)[:, 0]
            keep2 = (pos2 < cap2) & (e_in < e_per)
            pos2_c = torch.where(keep2, pos2, cap2 - 1)
            e_c = torch.where(keep2, e_in, 0)
            buf = torch.zeros((e_per, cap2, d), dtype=tok_in.dtype,
                              device=dev)
            buf = buf.index_put((e_c, pos2_c),
                                torch.where(keep2[:, None], tok_in, 0),
                                accumulate=True)
            out_buf = swiglu_hidden(buf, w_gate, w_up, gate_f32=True) @ w_down
            y_r = out_buf[e_c, pos2_c] * keep2[:, None].to(out_buf.dtype)

        y_back = a2a(y_r.reshape(tp, cap, d))
        y_tok = y_back[dest, pos_c]                             # [tl, D]
        y_tok = y_tok * (keep.float() * gate)[:, None].to(y_tok.dtype)
        return y_tok.reshape(bl, sl, d)

    return shard_map(routed, mesh, (x_spec, r_spec, w_spec, w_spec, wd_spec),
                     x_spec)(x, params["router"], params["w_gate"],
                             params["w_up"], params["w_down"])


def _moe_ffn_scatter(params: dict, x: torch.Tensor, cfg: ArchConfig,
                     dims: Dims) -> torch.Tensor:
    """The capacity-buffer scatter dispatch. Its capacity is global over
    the batch's tokens, so on a mesh the routing and the scatter into the
    buffer see every token (replicated), and the buffer is then laid out
    ``('expert', 'expert_cap')``."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.num_experts
    cap = _capacity(t, cfg)

    # the capacity is global: on a mesh every rank routes every token
    xf = constrain(x, None, None, None).reshape(t, d)
    logits = constrain(dot_f32(xf, params["router"]), None, None)  # [T, E]
    # llama4 routes with sigmoid gates on the top-1 expert; argmax takes
    # the first maximum, as the reference's does
    eidx = torch.argmax(logits, dim=-1)                         # [T]
    gate = torch.sigmoid(logits.amax(dim=-1))                   # [T]

    onehot = F.one_hot(eidx, e)                                 # [T, E]
    pos = torch.take_along_dim(torch.cumsum(onehot, dim=0) - 1,
                               eidx[:, None], dim=1)[:, 0]      # [T]
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)

    def scatter(xf, eidx, pos_c, keep):
        buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=xf.device)
        return buf.index_put_((eidx, pos_c),
                              torch.where(keep[:, None], xf, 0),
                              accumulate=True)

    buf = full_on_ranks(scatter, xf, eidx, pos_c, keep)
    buf = constrain(buf, "expert", "expert_cap", None)

    h = swiglu_hidden(buf, params["w_gate"], params["w_up"], gate_f32=True)
    h = constrain(h, "expert", "expert_cap", "expert_ffn")
    out_buf = h @ params["w_down"]
    out_buf = constrain(out_buf, "expert", "expert_cap", None)

    y = full_on_ranks(lambda o, i, j: o[i, j], out_buf, eidx, pos_c)  # [T, D]
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
