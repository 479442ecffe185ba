"""Canonical step functions: train_step / prefill_step / decode_step
(src/repro/launch/steps.py).

The launchers (``launch/train.py``, ``launch/serve.py``), the tests and
the chip smoke test call these, so all exercise the same code.

The train step takes its gradients with autograd and updates the state in
place under ``torch.no_grad()`` (the reference's jitted step donates its
state). Its forward runs no hand-written kernel: ``attn_impl="pallas"``
reaches the flash kernel and a card tensor of an SSM family the ``ssd``
kernel, and both refuse a gradient (``kernels/build.py: refuse_grad``),
as ``jax.grad`` through the reference's Pallas kernels fails.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import Dims
from repro_torch.nn.layers import cross_entropy
from repro_torch.nn.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.sharding import like


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """``attn_impl``: ``chunked`` | ``naive`` | ``pallas`` (the flash
    kernel). ``remat``/``remat_policy`` and ``microbatch`` (accumulation
    chunks along the batch) shape the train step only."""
    attn_impl: str = "chunked"
    remat: bool = True
    remat_policy: str = "nothing"      # 'nothing' | 'dots'
    microbatch: Optional[int] = None


def _inputs(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    return batch["embeds"] if cfg.frontend == "embed" else batch["tokens"]


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ArchConfig, dims: Dims, opts: StepOptions):
    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = model_lib.forward(
            params, _inputs(cfg, batch), cfg, dims,
            mode="train", attn_impl=opts.attn_impl, remat=opts.remat,
            remat_policy=opts.remat_policy,
        )
        # padded vocab tail never receives probability mass from labels
        return cross_entropy(logits, batch["labels"], batch.get("valid"))
    return loss_fn


def make_train_step(cfg: ArchConfig, dims: Dims, optimizer: AdamW,
                    opts: StepOptions = StepOptions()):
    """``train_step(state, batch)`` -> (state, {"loss", "grad_norm",
    "step"}), the state updated in place."""
    loss_fn = make_loss_fn(cfg, dims, opts)

    def value_and_grad(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            # a leaf the loss never reads (a stub front end's embedding
            # table) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                        materialize_grads=True)
        # on a mesh each gradient takes its parameter's layout (the
        # data-parallel reduction)
        return loss.detach(), tree_unflatten(leaves, [
            like(g, p) for g, p in zip(grads, tree_leaves(leaves))])

    def grads_of(params, batch):
        if not opts.microbatch or opts.microbatch <= 1:
            return value_and_grad(params, batch)
        n = opts.microbatch
        if any(x.shape[0] % n for x in batch.values()):
            raise ValueError(f"microbatch {n} does not divide the batch")
        loss_a = torch.zeros((), dtype=torch.float32,
                             device=tree_leaves(params)[0].device)
        g_a = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, g = value_and_grad(params, mb)
            loss_a = loss_a + loss / n
            for a, b in zip(tree_leaves(g_a), tree_leaves(g)):
                a.add_(b.float() / n)
            del g
        return loss_a, g_a

    def train_step(state: TrainState, batch):
        loss, grads = grads_of(state.params, batch)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": opt.step.float()}
        return TrainState(params, opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, dims: Dims,
                      opts: StepOptions = StepOptions(),
                      s_max: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model_lib.forward(
            params, _inputs(cfg, batch), cfg, dims,
            mode="prefill", s_max=s_max, attn_impl=opts.attn_impl,
        )
        # next-token logits only — callers sample from the last position
        return logits[:, -1, :], cache
    return prefill_step


def make_prefill_forward(cfg: ArchConfig, dims: Dims,
                         opts: StepOptions = StepOptions()):
    """Inference forward WITHOUT cache materialization (batch scoring /
    filtering workloads)."""
    @torch.no_grad()
    def prefill_forward(params, batch):
        logits = model_lib.forward(
            params, _inputs(cfg, batch), cfg, dims,
            mode="train", attn_impl=opts.attn_impl, remat=False,
        )
        return logits[:, -1, :]
    return prefill_forward


def make_decode_step(cfg: ArchConfig, dims: Dims):
    """``decode_step(params, cache, token_or_embed, pos)`` -> (logits [B,
    V], cache); the cache is updated in place."""
    @torch.no_grad()
    def decode_step(params, cache, token_or_embed, pos):
        logits, cache = model_lib.decode(params, token_or_embed, cache, pos,
                                         cfg, dims)
        return logits[:, -1, :], cache
    return decode_step
