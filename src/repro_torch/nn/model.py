"""Model assembly over stacked layer groups (src/repro/nn/model.py).

Parameters of the repeated unit are stacked on a leading dim, as the
reference stacks them for ``jax.lax.scan``; here a Python loop over that
dim takes the scan's place. The unit is a *group* (see blocks.py):
  dense   — 1 dense block per group, L groups
  moe     — ``layer_period`` blocks per group (period-1 dense FFN + 1 MoE)
  ssm     — 1 Mamba2 block per group
  hybrid  — ``hybrid_attn_period`` ssm blocks + one application of the
            weight-tied shared attention block; tail layers after

Caches mirror the group structure so prefill output == decode input. A
decode step updates the cache in place (the reference donates it).

Training checkpoints each group step and each tail step (``remat``), as
the reference wraps its scan bodies in ``jax.checkpoint``: ``"nothing"``
saves only the step's input and recomputes the rest in the backward
pass; ``"dots"`` also saves the outputs of the unbatched matmuls
(``aten.mm``/``aten.addmm``), as ``dots_with_no_batch_dims_saveable``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import blocks
from repro_torch.nn.attention import kv_cache_spec
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import embed, embed_spec, lm_logits, norm_spec, rmsnorm
from repro_torch.nn.params import (ParamSpec, abstract_params, build_axes,
                                   build_params, stack, tree_index,
                                   tree_map, tree_stack)
from repro_torch.nn.ssm import ssm_cache_spec
from repro_torch.parallel.sharding import constrain, like

# Activation-checkpoint policies: 'nothing' = full remat (recompute
# everything in the backward pass: smallest live set, most recompute);
# 'dots' = save matmul outputs (no matmul recompute, bigger live set).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = {"nothing": None, "dots": _save_dots}


def _remat_step(fn: Callable[[torch.Tensor], torch.Tensor],
                policy: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn`` checkpointed under ``policy`` (a key of ``REMAT_POLICIES``)."""
    save = REMAT_POLICIES[policy]
    kw = {} if save is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, save)}
    return lambda x: checkpoint(fn, x, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def group_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_groups, blocks_per_group, n_tail_ssm_layers)."""
    if cfg.family == "dense":
        return cfg.num_layers, 1, 0
    if cfg.family == "moe":
        p = cfg.moe.layer_period
        assert cfg.num_layers % p == 0, "moe period must divide num_layers"
        return cfg.num_layers // p, p, 0
    if cfg.family == "ssm":
        return cfg.num_layers, 1, 0
    if cfg.family == "hybrid":
        p = cfg.hybrid_attn_period
        return cfg.num_layers // p, p, cfg.num_layers % p
    raise ValueError(cfg.family)


def _group_spec(cfg: ArchConfig, dims: Dims) -> dict:
    if cfg.family == "dense":
        return blocks.dense_block_spec(cfg, dims)
    if cfg.family == "moe":
        p = cfg.moe.layer_period
        spec: Dict[str, Any] = {"moe": blocks.moe_block_spec(cfg, dims)}
        if p > 1:
            spec["subs"] = stack(blocks.dense_block_spec(cfg, dims), p - 1)
        return spec
    if cfg.family == "ssm":
        return blocks.ssm_block_spec(cfg, dims)
    if cfg.family == "hybrid":
        p = cfg.hybrid_attn_period
        return {"ssm_subs": stack(blocks.ssm_block_spec(cfg, dims), p)}
    raise ValueError(cfg.family)


def model_spec(cfg: ArchConfig, dims: Dims) -> dict:
    n_groups, _, tail = group_layout(cfg)
    spec: Dict[str, Any] = {
        "embed": embed_spec(dims, cfg.tie_embeddings),
        "groups": stack(_group_spec(cfg, dims), n_groups),
        "final_norm": norm_spec(dims.d_model),
    }
    if cfg.family == "hybrid":
        spec["shared_attn"] = blocks.dense_block_spec(cfg, dims)
        if tail:
            spec["tail"] = stack(blocks.ssm_block_spec(cfg, dims), tail)
    return spec


def init_params(cfg: ArchConfig, dims: Dims, generator: torch.Generator,
                device=None):
    return build_params(model_spec(cfg, dims), generator, device)


def param_axes(cfg: ArchConfig, dims: Dims):
    return build_axes(model_spec(cfg, dims))


def abstract_model_params(cfg: ArchConfig, dims: Dims):
    return abstract_params(model_spec(cfg, dims))


# ---------------------------------------------------------------------------
# Cache layout (mirrors groups)
# ---------------------------------------------------------------------------


def group_cache_spec(cfg: ArchConfig, dims: Dims, batch: int, s_max: int):
    """Cache spec for ONE group."""
    _, p, _ = group_layout(cfg)
    if cfg.family == "dense":
        return kv_cache_spec(batch, s_max, dims, quant=cfg.kv_quant)
    if cfg.family == "moe":
        g = {"moe": kv_cache_spec(batch, s_max, dims, quant=cfg.kv_quant)}
        if p > 1:
            g["subs"] = stack(
                kv_cache_spec(batch, s_max, dims, quant=cfg.kv_quant), p - 1)
        return g
    if cfg.family == "ssm":
        return ssm_cache_spec(batch, cfg, dims)
    if cfg.family == "hybrid":
        return {
            "ssm_subs": stack(ssm_cache_spec(batch, cfg, dims), p),
            "attn": kv_cache_spec(batch, s_max, dims, quant=cfg.kv_quant),
        }
    raise ValueError(cfg.family)


def cache_spec(cfg: ArchConfig, dims: Dims, batch: int, s_max: int) -> dict:
    n_groups, p, tail = group_layout(cfg)
    g = group_cache_spec(cfg, dims, batch, s_max)
    spec: Dict[str, Any] = {"groups": stack(g, n_groups)}
    if cfg.family == "hybrid" and tail:
        spec["tail"] = stack(ssm_cache_spec(batch, cfg, dims), tail)
    return spec


def init_cache(cfg: ArchConfig, dims: Dims, batch: int, s_max: int,
               device=None):
    zeroed = tree_map(
        lambda s: ParamSpec(s.shape, s.logical, init="zeros", dtype=s.dtype),
        cache_spec(cfg, dims, batch, s_max))
    return build_params(zeroed, torch.Generator(), device)


def abstract_cache(cfg: ArchConfig, dims: Dims, batch: int, s_max: int):
    return abstract_params(cache_spec(cfg, dims, batch, s_max))


def cache_axes(cfg: ArchConfig, dims: Dims, batch: int, s_max: int):
    return build_axes(cache_spec(cfg, dims, batch, s_max))


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def forward(
    params: dict,
    inputs: torch.Tensor,           # tokens [B,S] int | embeds [B,S,D]
    cfg: ArchConfig,
    dims: Dims,
    *,
    mode: str = "train",            # train | prefill
    s_max: Optional[int] = None,    # cache capacity for prefill
    attn_impl: str = "chunked",
    remat: bool = True,
    remat_policy: str = "nothing",
):
    """Returns logits [B,S,V] (and the cache tree when mode='prefill').
    ``remat`` checkpoints each group and tail step when no cache is built
    (see the module docstring)."""
    want_cache = mode == "prefill"
    if cfg.frontend == "text":
        x = embed(params["embed"], inputs)
    else:
        x = inputs                                   # stub frontend: embeddings
    b, s = x.shape[:2]
    s_max = s_max or s
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x = constrain(x, "batch", "seq", None)
    n_groups, p, tail = group_layout(cfg)
    shared = params.get("shared_attn")
    blk = dict(positions=positions, attn_impl=attn_impl,
               return_cache=want_cache, s_max=s_max)

    remat = remat and not want_cache
    if remat and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}")

    group_caches = []
    for i in range(n_groups):
        gp = tree_index(params["groups"], i)
        if remat:
            x = _remat_step(lambda x, gp=gp: _group_forward(
                gp, x, cfg, dims, p, shared, blk)[0], remat_policy)(x)
            continue
        x, c = _group_forward(gp, x, cfg, dims, p, shared, blk)
        group_caches.append(c)

    tail_caches = []
    for j in range(tail):
        lp = tree_index(params["tail"], j)
        if remat:
            x = _remat_step(lambda x, lp=lp: blocks.ssm_block(
                lp, x, cfg, dims)[0], remat_policy)(x)
            continue
        x, _, c = blocks.ssm_block(lp, x, cfg, dims,
                                   return_cache=want_cache)
        tail_caches.append(c)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x)
    logits = constrain(logits, "batch", "seq", None)
    if not want_cache:
        return logits
    cache = {}
    if group_caches:
        cache["groups"] = tree_stack(group_caches)
    if tail_caches:
        cache["tail"] = tree_stack(tail_caches)
    # on a mesh, in the cache's own layout (the reference's out_shardings)
    axes = cache_axes(cfg, dims, b, s_max)
    cache = tree_map(lambda c, ax: constrain(c, *ax), cache,
                     {k: axes[k] for k in cache})
    return logits, cache


def _group_forward(gp, x, cfg, dims, p, shared, blk):
    """One group (the reference's scan body). Returns (x, caches or
    None)."""
    want_cache = blk["return_cache"]
    if cfg.family == "dense":
        x, _, kv = blocks.dense_block(gp, x, cfg, dims, **blk)
        return x, kv

    if cfg.family == "moe":
        caches: Dict[str, Any] = {}
        xf, sub_caches = None, []
        for j in range(p - 1):
            x, xf, kv = blocks.dense_block(tree_index(gp["subs"], j), x, cfg,
                                           dims, xf=xf, **blk)
            sub_caches.append(kv)
        if sub_caches and want_cache:
            caches["subs"] = tree_stack(sub_caches)
        x, _, caches["moe"] = blocks.dense_block(gp["moe"], x, cfg, dims,
                                                 xf=xf, **blk)
        return x, (caches if want_cache else None)

    if cfg.family == "ssm":
        x, _, c = blocks.ssm_block(gp, x, cfg, dims, return_cache=want_cache)
        return x, c

    if cfg.family == "hybrid":
        xf, ssm_caches = None, []
        for j in range(p):
            x, xf, c = blocks.ssm_block(tree_index(gp["ssm_subs"], j), x,
                                        cfg, dims, return_cache=want_cache,
                                        xf=xf)
            ssm_caches.append(c)
        x, _, kv = blocks.dense_block(shared, x, cfg, dims, xf=xf, **blk)
        if not want_cache:
            return x, None
        return x, {"ssm_subs": tree_stack(ssm_caches), "attn": kv}

    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------


def _write_back(dst, src) -> None:
    """Copy a block's new cache into its (view of the) stacked cache, in
    the cache's layout; the attention caches were written in place
    already."""
    tree_map(lambda d, s: None if s is d else d.copy_(like(s, d)), dst, src)


def decode(
    params: dict,
    token_or_embed: torch.Tensor,   # [B,1] int | [B,1,D]
    cache: dict,
    pos: int,                       # write index
    cfg: ArchConfig,
    dims: Dims,
):
    """One decode step. Returns (logits [B,1,V], cache), the cache updated
    in place."""
    if cfg.frontend == "text":
        x = embed(params["embed"], token_or_embed)
    else:
        x = token_or_embed
    x = constrain(x, "batch", None, None)

    n_groups, p, tail = group_layout(cfg)
    shared = params.get("shared_attn")
    for i in range(n_groups):
        x = _group_decode(tree_index(params["groups"], i),
                          tree_index(cache["groups"], i), x, pos, cfg, dims,
                          p, shared)
    for j in range(tail):
        lc = tree_index(cache["tail"], j)
        x, _, c = blocks.ssm_block_decode(tree_index(params["tail"], j), x,
                                          lc, cfg, dims)
        _write_back(lc, c)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x)
    return logits, cache


def _group_decode(gp, gc, x, pos, cfg, dims, p, shared):
    """One group's decode step; writes its caches back into ``gc``."""
    xf = None

    def step(block, bp, bc, *extra):
        nonlocal x, xf
        x, xf, c = block(bp, x, bc, *extra, cfg, dims, xf=xf)
        _write_back(bc, c)

    if cfg.family == "dense":
        step(blocks.dense_block_decode, gp, gc, pos)
    elif cfg.family == "moe":
        for j in range(p - 1):
            step(blocks.dense_block_decode, tree_index(gp["subs"], j),
                 tree_index(gc["subs"], j), pos)
        step(blocks.dense_block_decode, gp["moe"], gc["moe"], pos)
    elif cfg.family == "ssm":
        step(blocks.ssm_block_decode, gp, gc)
    elif cfg.family == "hybrid":
        for j in range(p):
            step(blocks.ssm_block_decode, tree_index(gp["ssm_subs"], j),
                 tree_index(gc["ssm_subs"], j))
        step(blocks.dense_block_decode, shared, gc["attn"], pos)
    else:
        raise ValueError(cfg.family)
    return x
