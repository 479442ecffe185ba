"""Per-group dry-run probes (src/repro/launch/group_probe.py).

The reference scans its layer groups, so XLA's ``cost_analysis()`` counts
the scan body once, and its roofline adds ``(n_groups - 1) * group`` back.
The port loops over groups eagerly, so its full-cell dry-run counts every
group; a group probe is ONE group's cost under the same mesh and layouts,
and the identity the reference's roofline rebuilds holds exactly:

    full = n_groups * group (+ n_tail * tail for the hybrid tail) + rest

Each ``build_*`` function returns ``(fn, args)``: ``fn(*args)`` runs the group's code
as the full step runs it (the train probe: forward, remat matched to the
step, and backward against a cotangent; prefill and decode without
autograd, as their steps run).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.nn import blocks
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import Dims
from repro_torch.nn.params import (abstract_params, build_axes, tree_leaves,
                                   tree_unflatten)
from repro_torch.nn.ssm import ssm_cache_spec
from repro_torch.parallel.sharding import current_rules, spec_for, tree_specs


def _fake_tree(spec_tree, mesh, fake_tree):
    """Shape-only params of ``spec_tree`` placed on ``mesh`` by the
    rules (``fake_tree(abstract, specs, mesh)``, from the dry-run)."""
    abs_ = abstract_params(spec_tree)
    return fake_tree(abs_, tree_specs(abs_, build_axes(spec_tree), mesh,
                                      current_rules()), mesh)


def _activation(shape, logical, mesh, fake_tree, dtype=torch.bfloat16):
    x = torch.empty(shape, dtype=dtype, device="meta")
    return fake_tree(x, spec_for(shape, logical, mesh, current_rules()), mesh)


def _grad_probe(step, params, x, ct):
    """Forward of ``step`` and the backward to its params and input."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = step(tree, x)
        grads = torch.autograd.grad(y, leaves + [x], ct)
    return y, grads


def build_group_cell(cfg: ArchConfig, dims: Dims, shape: ShapeSpec, mesh,
                     fake_tree, attn_impl: str = "chunked", remat: bool = True,
                     remat_policy: str = "nothing",
                     quant: str = None) -> Tuple[Any, tuple]:
    """(fn, args) for ONE group step of the given cell kind — the exact
    block code the full model loops over."""
    b, s = shape.global_batch, shape.seq_len
    _, p, _ = model_lib.group_layout(cfg)
    gp = _fake_tree(model_lib._group_spec(cfg, dims), mesh, fake_tree)
    shared = (_fake_tree(blocks.dense_block_spec(cfg, dims), mesh, fake_tree)
              if cfg.family == "hybrid" else None)

    if shape.kind in ("train", "prefill"):
        x = _activation((b, s, dims.d_model), ("batch", "seq", None), mesh,
                        fake_tree)
        positions = torch.arange(s, dtype=torch.int32,
                                 device="meta").expand(b, s)
        blk = dict(positions=positions, attn_impl=attn_impl,
                   return_cache=shape.kind == "prefill", s_max=s)

        if shape.kind == "prefill":
            @torch.no_grad()
            def prefill_probe(gp, x):
                return model_lib._group_forward(gp, x, cfg, dims, p, shared,
                                                blk)
            return prefill_probe, (gp, x)

        def y_of(g, x):
            return model_lib._group_forward(g, x, cfg, dims, p, shared,
                                            blk)[0]
        if remat:
            def step(g, x):
                return model_lib._remat_step(lambda x: y_of(g, x),
                                             remat_policy)(x)
        else:
            step = y_of
        ct = _activation((b, s, dims.d_model), ("batch", "seq", None), mesh,
                         fake_tree)

        def train_probe(gp, x, ct):
            return _grad_probe(step, gp, x, ct)
        return train_probe, (gp, x, ct)

    # decode: one group decode step against this cell's cache depth
    gc = _fake_tree(model_lib.group_cache_spec(cfg, dims, b, s), mesh,
                    fake_tree)
    x = _activation((b, 1, dims.d_model), ("batch", None, None), mesh,
                    fake_tree)
    dequant = None
    if quant == "w8":
        from repro_torch.core import lm_quant
        spec = model_lib._group_spec(cfg, dims)
        abs_ = abstract_params(spec)
        q_abs = lm_quant.abstract_quantized(abs_)
        q_axes = lm_quant.quantized_axes(abs_, build_axes(spec))
        gp = fake_tree(q_abs, tree_specs(q_abs, q_axes, mesh, current_rules()),
                       mesh)
        dequant = lm_quant.dequantize_params

    @torch.no_grad()
    def decode_probe(gp, gc, x):
        if dequant is not None:
            gp = dequant(gp)
        return model_lib._group_decode(gp, gc, x, s - 1, cfg, dims, p, shared)
    return decode_probe, (gp, gc, x)


def build_tail_cell(cfg: ArchConfig, dims: Dims, shape: ShapeSpec, mesh,
                    fake_tree) -> Tuple[Any, tuple]:
    """One hybrid-tail ssm block."""
    assert cfg.family == "hybrid"
    b, s = shape.global_batch, shape.seq_len
    lp = _fake_tree(blocks.ssm_block_spec(cfg, dims), mesh, fake_tree)

    if shape.kind in ("train", "prefill"):
        x = _activation((b, s, dims.d_model), ("batch", "seq", None), mesh,
                        fake_tree)
        if shape.kind == "prefill":
            @torch.no_grad()
            def f(lp, x):
                return blocks.ssm_block(lp, x, cfg, dims, return_cache=True)
            return f, (lp, x)

        def step(g, x):
            return model_lib._remat_step(
                lambda x: blocks.ssm_block(g, x, cfg, dims)[0], "nothing")(x)

        def train_probe(lp, x, ct):
            return _grad_probe(step, lp, x, ct)
        return train_probe, (lp, x, x)

    c = _fake_tree(ssm_cache_spec(b, cfg, dims), mesh, fake_tree)
    x = _activation((b, 1, dims.d_model), ("batch", None, None), mesh,
                    fake_tree)

    @torch.no_grad()
    def decode_probe(lp, x, c):
        return blocks.ssm_block_decode(lp, x, c, cfg, dims)
    return decode_probe, (lp, x, c)
