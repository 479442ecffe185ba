"""Grouped-query attention with RoPE, KV cache, and memory-bounded softmax
(src/repro/nn/attention.py).

Three interchangeable implementations (``impl=``):

* ``naive``   — materializes the full [.., S, S] score matrix. Reference.
* ``chunked`` — a loop over query chunks; each step computes exact
  softmax rows against the full key set, so peak memory is O(chunk × S)
  instead of O(S²).
* ``pallas``  — the reference's name for its flash-attention kernel:
  here ``repro_torch.kernels.flash_attention`` (the CUDA kernel on a card
  tensor, its plain version on a CPU one).

Decode attends one new token against a cached [B, S_max, Hkv, hd] KV,
written in place at ``pos`` (as the reference's donated cache lets its
compiler do).

On a mesh the heads are sharded over 'model' and the attention core runs
on each rank's local heads (``parallel.sharding.shard_map``): the flash
kernel takes local tensors only, and every impl is per (row, head), so
no collective runs inside.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lm_quant import dequantize_kv, quantize_kv
from repro_torch.kernels import flash_attention as flash
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import apply_rope
from repro_torch.nn.params import ParamSpec, build_params, tree_map
from repro_torch.parallel.sharding import (constrain, current_mesh,
                                           current_rules, local_op, shard_map,
                                           spec_for, sp_gather_seq,
                                           tp_proj_scatter, write_at)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_spec(cfg: ArchConfig, dims: Dims) -> dict:
    d, hq, hkv, hd = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    spec = {
        "w_q": ParamSpec((d, hq, hd), ("fsdp", "heads", None)),
        "w_k": ParamSpec((d, hkv, hd), ("fsdp", "kv_heads", None)),
        "w_v": ParamSpec((d, hkv, hd), ("fsdp", "kv_heads", None)),
        "w_o": ParamSpec((hq, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        spec["b_q"] = ParamSpec((hq, hd), ("heads", None), init="zeros")
        spec["b_k"] = ParamSpec((hkv, hd), ("kv_heads", None), init="zeros")
        spec["b_v"] = ParamSpec((hkv, hd), ("kv_heads", None), init="zeros")
    return spec


def _project_qkv(params, x, cfg: ArchConfig, positions):
    # SP -> TP transition: all-gather the sequence dim ONCE on the [B,S,D]
    # activation, so the three projections read gathered x and emit
    # head-sharded outputs with no further collectives.
    x = sp_gather_seq(x)

    def proj(name, heads, rope):
        # on each rank's rows and heads: the projection, its bias, RoPE
        ops = [(x, ("batch", None, None)),
               (params[f"w_{name}"], (None, heads, None))]
        if cfg.qkv_bias:
            ops.append((params[f"b_{name}"], (heads, None)))
        ops.append((positions, ("batch", None)))

        def f(x, w, *rest):
            *bias, pos = rest
            y = _in_proj(x, w)
            if bias:
                y = y + bias[0]
            return apply_rope(y, pos, cfg.rope_theta) if rope else y
        return local_op(f, ("batch", None, heads, None), *ops)

    q = proj("q", "heads", True)
    k = proj("k", "kv_heads", True)
    v = proj("v", "kv_heads", False)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def _in_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bsd,dhk->bshk`` as one matmul over the flattened heads (the GEMM
    einsum makes)."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _out_proj(out: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """``bshk,hkd->bsd`` as one matmul over the flattened heads."""
    return out.flatten(-2) @ w_o.flatten(0, 1)


# ---------------------------------------------------------------------------
# Cores
# ---------------------------------------------------------------------------


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _attend_rows(q_i, k, v, scale: float, q0: int) -> torch.Tensor:
    """Exact causal attention of query rows ``q0 ..`` (``q_i`` [b, rows,
    kv, g, hd]) against every key."""
    rows, sk = q_i.shape[1], k.shape[1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q_i, k).float() * scale
    qpos = q0 + torch.arange(rows, device=q_i.device)
    mask = qpos[:, None] >= torch.arange(sk, device=q_i.device)[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_i.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _attend_naive(q, k, v, scale: float) -> torch.Tensor:
    b, sq, n_kv, g, hd = q.shape
    return _attend_rows(q, k, v, scale, 0).reshape(b, sq, n_kv * g, hd)


def _attend_chunked(q, k, v, scale: float, chunk: int) -> torch.Tensor:
    """Exact causal attention, O(chunk*S) memory, a loop over query
    chunks (the last one shorter when ``chunk`` does not divide S)."""
    b, s, n_kv, g, hd = q.shape
    outs = [_attend_rows(q[:, i:i + chunk], k, v, scale, i)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1).reshape(b, s, n_kv * g, hd)


def multihead_attention(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    dims: Dims,
    positions: torch.Tensor,
    impl: str = "chunked",
    chunk: int = 512,
    return_kv: bool = False,
    s_max: Optional[int] = None,
):
    """Full (train/prefill) causal self-attention. x: [B, S, D].

    With ``return_kv``, also returns the rope'd K/V (padded to ``s_max``)
    so prefill can hand a cache to the decode loop."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    scale = dims.head_dim ** -0.5
    s = x.shape[1]
    if impl not in ("pallas", "naive", "chunked"):
        raise ValueError(f"unknown attention impl {impl!r}")

    def core(q, k, v):
        if impl == "pallas":
            return flash.flash_attention(q, k, v, causal=True)
        qg = _group(q, k.shape[2])
        if impl == "naive" or s <= chunk:
            return _attend_naive(qg, k, v, scale)
        return _attend_chunked(qg, k, v, scale, min(chunk, s))

    out = _local_heads(core, q, k, v)
    out = constrain(out, "batch", None, "heads", None)
    # TP -> SP: the output projection and a reduce-scatter in one region
    y = tp_proj_scatter(out, params["w_o"], _out_proj,
                        ("batch", None, "heads", None), w_sharded_dim=0)
    if not return_kv:
        return y
    pad = (s_max or s) - s
    if pad:
        # on each rank's rows and heads: the padded dim is whole there
        kv = ("batch", None, "kv_heads", None)
        k, v = (local_op(lambda a: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, pad)), kv, (a, kv)) for a in (k, v))
    if cfg.kv_quant:
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
        return y, {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    return y, {"k": k, "v": v}


def _local_heads(core, q, k, v):
    """``core(q, k, v)`` -> [B, S, H, hd]; on a mesh, on each rank's
    local rows and heads (q's heads and k/v's must split alike, which
    ``nn/dims.py`` pads for)."""
    mesh = current_mesh()
    if mesh is None:
        return core(q, k, v)
    rules = current_rules()
    q_spec = spec_for(q.shape, ("batch", None, "heads", None), mesh, rules)
    kv_spec = spec_for(k.shape, ("batch", None, "kv_heads", None), mesh, rules)
    if q_spec[2] != kv_spec[2]:
        raise ValueError(f"q heads {q.shape[2]} and kv heads {k.shape[2]} "
                         f"split differently on {mesh}")
    return shard_map(core, mesh, (q_spec, kv_spec, kv_spec), q_spec)(q, k, v)


# ---------------------------------------------------------------------------
# Decode (KV cache)
# ---------------------------------------------------------------------------


def kv_cache_spec(batch: int, s_max: int, dims: Dims, dtype=torch.bfloat16,
                  quant: bool = False) -> dict:
    shape = (batch, s_max, dims.num_kv_heads, dims.head_dim)
    if quant:
        # INT8 codes + per-(b, pos, head) f32 scales: halves the
        # decode-dominating cache reads vs bf16.
        sshape = (batch, s_max, dims.num_kv_heads)
        ax = ("batch", None, "kv_heads", None)
        sax = ("batch", None, "kv_heads")
        return {
            "k_q": ParamSpec(shape, ax, init="zeros", dtype=torch.int8),
            "k_s": ParamSpec(sshape, sax, init="zeros", dtype=torch.float32),
            "v_q": ParamSpec(shape, ax, init="zeros", dtype=torch.int8),
            "v_s": ParamSpec(sshape, sax, init="zeros", dtype=torch.float32),
        }
    return {
        "k": ParamSpec(shape, ("batch", None, "kv_heads", None), dtype=dtype),
        "v": ParamSpec(shape, ("batch", None, "kv_heads", None), dtype=dtype),
    }


def init_kv_cache(batch: int, s_max: int, dims: Dims, dtype=torch.bfloat16,
                  quant: bool = False, device=None) -> dict:
    """A zeroed cache (the reference's ``normal`` k/v specs draw random
    values there; a decode writes each position before it attends to
    it, so the values never matter)."""
    spec = tree_map(lambda s: ParamSpec(s.shape, s.logical, init="zeros",
                                        dtype=s.dtype),
                    kv_cache_spec(batch, s_max, dims, dtype, quant))
    return build_params(spec, torch.Generator(), device)


def decode_attention(
    params: dict,
    x: torch.Tensor,
    cache: dict,
    pos: int,
    cfg: ArchConfig,
    dims: Dims,
) -> Tuple[torch.Tensor, dict]:
    """One-token step. x: [B, 1, D]; cache k/v: [B, S_max, Hkv, hd];
    pos: the index the new token is written at (attends 0..pos). The
    cache is updated in place and returned."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    if cfg.kv_quant:
        # int8 cache: update codes+scales in place, attend on the
        # dequantized view
        kq_new, ks_new = quantize_kv(k_new)
        vq_new, vs_new = quantize_kv(v_new)
        for name, val in (("k_q", kq_new), ("k_s", ks_new),
                          ("v_q", vq_new), ("v_s", vs_new)):
            write_at(cache[name], pos, val)
        k = dequantize_kv(cache["k_q"], cache["k_s"], x.dtype)
        v = dequantize_kv(cache["v_q"], cache["v_s"], x.dtype)
        k = constrain(k, "batch", None, "kv_heads", None)
        v = constrain(v, "batch", None, "kv_heads", None)
        return _decode_core(params, x, q, k, v, pos, dims), cache

    write_at(cache["k"], pos, k_new.to(cache["k"].dtype))
    write_at(cache["v"], pos, v_new.to(cache["v"].dtype))
    k = constrain(cache["k"], "batch", None, "kv_heads", None)
    v = constrain(cache["v"], "batch", None, "kv_heads", None)
    return _decode_core(params, x, q, k, v, pos, dims), cache


def _decode_core(params, x, q, k, v, pos, dims) -> torch.Tensor:
    scale = dims.head_dim ** -0.5

    def core(q, k, v):
        b, _, hq, hd = q.shape
        qg = _group(q, k.shape[2])[:, 0]                    # [B, kv, g, hd]
        s_max = k.shape[1]
        scores = torch.einsum("bkgh,bskh->bkgs", qg, k).float() * scale
        mask = torch.arange(s_max, device=q.device) <= pos
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgs,bskh->bkgh", probs, v)
        return out.reshape(b, 1, hq, hd)

    return _out_proj(_local_heads(core, q, k, v), params["w_o"])
