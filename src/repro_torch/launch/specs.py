"""Shape-only stand-ins for every model input and state, and their layouts
(src/repro/launch/specs.py).

Meta tensors take the place of the reference's ``ShapeDtypeStruct``: shape
and dtype, no allocation. The dry-run runs against fakes of these, and the
launcher shards its state with the same functions, so dry-run and real
launch cannot drift. A layout here is a per-dim spec
(``parallel/sharding.py: spec_for``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import Dims
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.sharding import spec_for, tree_specs

# logical axes for batch fields
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "embeds": ("batch", "seq", None),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, dims: Dims, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract model inputs for one (arch x shape) cell.

    train/prefill: the full batch. decode: one new token (or stub frame
    embedding) per sequence."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out: Dict[str, Any] = {"labels": _meta((b, s), torch.int32)}
        if cfg.frontend == "text":
            out["tokens"] = _meta((b, s), torch.int32)
        else:
            out["embeds"] = _meta((b, s, dims.d_model), torch.bfloat16)
        return out
    # decode: single-token step against a seq_len-deep cache
    if cfg.frontend == "text":
        return {"token": _meta((b, 1), torch.int32)}
    return {"token": _meta((b, 1, dims.d_model), torch.bfloat16)}


def batch_axes(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Tuple]:
    specs = {}
    if shape.kind in ("train", "prefill"):
        specs["labels"] = BATCH_AXES["labels"]
        specs["tokens" if cfg.frontend == "text" else "embeds"] = (
            BATCH_AXES["tokens"] if cfg.frontend == "text" else BATCH_AXES["embeds"])
    else:
        specs["token"] = ("batch", None) if cfg.frontend == "text" \
            else ("batch", None, None)
    return specs


def abstract_train_state(cfg: ArchConfig, dims: Dims, optimizer: AdamW):
    params = model_lib.abstract_model_params(cfg, dims)
    return params, optimizer.abstract_init(params)


def state_axes(cfg: ArchConfig, dims: Dims):
    """Logical axes for params and optimizer state (state inherits params')."""
    p_axes = model_lib.param_axes(cfg, dims)
    opt_axes = {
        "step": (),
        "m": p_axes,
        "v": p_axes,
        "master": p_axes,
    }
    return p_axes, opt_axes


def shardings_for_cell(cfg: ArchConfig, dims: Dims, shape: ShapeSpec,
                       mesh, optimizer: AdamW, rules=None) -> Dict[str, Any]:
    """The cell's layouts: trees of specs for ``params``, ``opt`` (train),
    ``cache`` (decode) and ``inputs``."""
    p_axes, _ = state_axes(cfg, dims)
    params_abs = model_lib.abstract_model_params(cfg, dims)
    p_spec = tree_specs(params_abs, p_axes, mesh, rules)

    out: Dict[str, Any] = {"params": p_spec}
    if shape.kind == "train":
        opt_abs = optimizer.abstract_init(params_abs)
        out["opt"] = AdamWState(
            step=spec_for((), (), mesh, rules),
            m=tree_specs(opt_abs.m, p_axes, mesh, rules),
            v=tree_specs(opt_abs.v, p_axes, mesh, rules),
            master=tree_specs(opt_abs.master, p_axes, mesh, rules))
    if shape.kind == "decode":
        cache_abs = model_lib.abstract_cache(cfg, dims, shape.global_batch,
                                             shape.seq_len)
        cache_ax = model_lib.cache_axes(cfg, dims, shape.global_batch,
                                        shape.seq_len)
        out["cache"] = tree_specs(cache_abs, cache_ax, mesh, rules)
    inputs_abs = input_specs(cfg, dims, shape)
    in_ax = batch_axes(cfg, shape)
    out["inputs"] = {k: spec_for(tuple(v.shape), in_ax[k], mesh, rules)
                     for k, v in inputs_abs.items()}
    return out
