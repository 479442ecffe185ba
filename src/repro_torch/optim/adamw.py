"""AdamW with decoupled weight decay, global-norm clipping, and fp32 master
state over bf16 params (src/repro/optim/adamw.py).

State layout mirrors the param tree (nested dicts of tensors), so it
checkpoints like params: ``m`` / ``v`` / master weights per leaf, fp32,
and an int32 step counter. :meth:`AdamW.update` runs the reference's
arithmetic in the same order, every constant an fp32 tensor as the
reference's weak-typed Python floats become fp32 (bias corrections
``1 - b ** step`` and the schedule included), and writes the new state
and params in place (torch's idiom for the reference's donated buffers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.nn.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # scalar int32
    m: Any                    # fp32 tree
    v: Any                    # fp32 tree
    master: Any               # fp32 master weights


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an fp32 scalar tensor on ``like``'s device (the
    reference's weak-typed Python float meeting an fp32 array)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        dev = tree_leaves(params)[0].device
        # zeros_like keeps a sharded param's layout (a DTensor's placements)
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
            master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                            params),
        )

    def abstract_init(self, abstract_params) -> AdamWState:
        """Shape/dtype-only state on the ``meta`` device: no allocation."""
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                    device="meta")
        return AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=tree_map(f32, abstract_params),
            v=tree_map(f32, abstract_params),
            master=tree_map(f32, abstract_params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (params, state, grad_norm): ``params`` and the state's
        ``m``/``v``/``master`` updated in place, a new step counter."""
        gnorm = global_norm(grads)
        c = lambda v: _f32(v, gnorm)
        scale = None
        if self.clip_norm is not None:
            scale = torch.minimum(c(1.0),
                                  c(self.clip_norm) / (gnorm + c(1e-9)))

        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else c(self.lr)
        b1c = c(1.0) - torch.pow(c(self.b1), step.float())
        b2c = c(1.0) - torch.pow(c(self.b2), step.float())
        b1, b2, eps, wd = (c(self.b1), c(self.b2), c(self.eps),
                           c(self.weight_decay))
        nb1, nb2 = c(1.0 - self.b1), c(1.0 - self.b2)

        for g, m, v, w, p in zip(tree_leaves(grads), tree_leaves(state.m),
                                 tree_leaves(state.v),
                                 tree_leaves(state.master),
                                 tree_leaves(params)):
            g = (g.to(torch.float32, copy=True) if scale is None
                 else g.float() * scale)                # a fresh buffer
            m.mul_(b1).add_(nb1 * g)
            v.mul_(b2).add_(g.square_().mul_(nb2))     # g is spent here
            den = (v / b2c).sqrt_().add_(eps)
            upd = (m / b1c).div_(den)
            del den
            upd.add_(wd * w).mul_(lr)
            w.sub_(upd)
            p.copy_(w)
        return params, AdamWState(step, state.m, state.v, state.master), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 sums of squares, added in the
    reference's leaf order (sorted keys), which fixes the fp32 sum."""
    total = None
    for leaf in tree_leaves(tree):
        sq = leaf.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak``, then a cosine down to ``floor * peak`` at
    ``total``; ``lr(step)`` takes the int32 step tensor, fp32 inside."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        c = lambda v: _f32(v, step)
        warm = c(peak) * step / c(max(warmup, 1))
        prog = torch.clamp((step - c(warmup)) / c(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = c(floor * peak) + c((1 - floor) * peak * 0.5) * (
            c(1.0) + torch.cos(c(math.pi) * prog))
        return torch.where(step < c(warmup), warm, cos)
    return lr
