"""Residual blocks per family, in both full-sequence and decode forms
(src/repro/nn/blocks.py).

A *group* is the unit the model loops over (see model.py): dense/ssm
groups hold one block, moe groups hold ``layer_period`` blocks (dense FFN
subs + one MoE block), hybrid groups hold ``hybrid_attn_period`` ssm
blocks followed by one application of the weight-tied shared attention
block.

Each block takes, besides ``x``, its unrounded fp32 value ``xf`` when the
previous block of the same group made it (None at a group's start, where
the reference's scan carries ``x`` rounded), and returns ``(x, xf,
cache)``: its first RMSNorm reads ``xf``, as the reference's compiled
group body does (``layers.residual``).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm as ssm_mod
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import mlp, mlp_spec, norm_spec, residual, rmsnorm
from repro_torch.parallel.sharding import constrain


def _res(sums):
    """A full-sequence block's residual sum ``(x, xf)`` laid out (batch,
    seq) between blocks, as the reference constrains it (identity without
    a mesh)."""
    return tuple(constrain(a, "batch", "seq", None) for a in sums)

# ---------------------------------------------------------------------------
# Dense (attention + SwiGLU) block, and the MoE block (dense attention +
# routed FFN), which differ only in the FFN: one function serves both
# ---------------------------------------------------------------------------


def dense_block_spec(cfg: ArchConfig, dims: Dims) -> dict:
    return {
        "ln1": norm_spec(dims.d_model),
        "attn": attn_mod.attn_spec(cfg, dims),
        "ln2": norm_spec(dims.d_model),
        "mlp": mlp_spec(dims),
    }


def moe_block_spec(cfg: ArchConfig, dims: Dims) -> dict:
    return {
        "ln1": norm_spec(dims.d_model),
        "attn": attn_mod.attn_spec(cfg, dims),
        "ln2": norm_spec(dims.d_model),
        "moe": moe_mod.moe_spec(cfg, dims),
    }


def _ffn(params, x, xf, cfg, dims):
    h = rmsnorm(x, params["ln2"], cfg.norm_eps, xf)
    if "moe" in params:
        return residual(x, moe_mod.moe_ffn(params["moe"], h, cfg, dims))
    return residual(x, mlp(params["mlp"], h))


def dense_block(params, x, cfg, dims, positions, attn_impl="chunked",
                return_cache=False, s_max=None, xf=None):
    """The dense block, or the MoE block when ``params`` holds ``moe``.
    Returns (x, xf, kv cache or None)."""
    h = rmsnorm(x, params["ln1"], cfg.norm_eps, xf)
    a = attn_mod.multihead_attention(params["attn"], h, cfg, dims, positions,
                                     impl=attn_impl, return_kv=return_cache,
                                     s_max=s_max)
    kv = None
    if return_cache:
        a, kv = a
    x, xf = _res(residual(x, a))
    x, xf = _res(_ffn(params, x, xf, cfg, dims))
    return x, xf, kv


def dense_block_decode(params, x, cache, pos, cfg, dims, xf=None):
    h = rmsnorm(x, params["ln1"], cfg.norm_eps, xf)
    a, cache = attn_mod.decode_attention(params["attn"], h, cache, pos, cfg, dims)
    x, xf = residual(x, a)
    x, xf = _ffn(params, x, xf, cfg, dims)
    return x, xf, cache


# ---------------------------------------------------------------------------
# SSM block
# ---------------------------------------------------------------------------


def ssm_block_spec(cfg: ArchConfig, dims: Dims) -> dict:
    return {"ln": norm_spec(dims.d_model), "ssm": ssm_mod.ssm_spec(cfg, dims)}


def ssm_block(params, x, cfg, dims, return_cache=False, xf=None):
    """Returns (x, xf, ssm cache or None)."""
    h = rmsnorm(x, params["ln"], cfg.norm_eps, xf)
    y = ssm_mod.ssm_mixer(params["ssm"], h, cfg, dims,
                          return_cache=return_cache)
    cache = None
    if return_cache:
        y, cache = y
    return (*_res(residual(x, y)), cache)


def ssm_block_decode(params, x, cache, cfg, dims, xf=None):
    h = rmsnorm(x, params["ln"], cfg.norm_eps, xf)
    y, cache = ssm_mod.ssm_decode_step(params["ssm"], h, cache, cfg, dims)
    return (*residual(x, y), cache)
