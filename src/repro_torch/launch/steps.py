"""Canonical inference step functions: prefill_step / decode_step
(src/repro/launch/steps.py, its inference half; the train step comes with
the training slice).

The launcher and the chip smoke test call these, so both exercise the
same code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import Dims


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """``attn_impl``: ``chunked`` | ``naive`` | ``pallas`` (the flash
    kernel). The reference's remat and microbatch fields shape its train
    step only."""
    attn_impl: str = "chunked"


def _inputs(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    return batch["embeds"] if cfg.frontend == "embed" else batch["tokens"]


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
            mode="train", attn_impl=opts.attn_impl,
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
