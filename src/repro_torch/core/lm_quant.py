"""PTQ for the large-model serving path (src/repro/core/lm_quant.py).

(a) The model weights (w8a16): int8 codes plus one fp32 scale per tensor,
the bf16 math unchanged; the tree mirrors the bf16 param tree, so the same
logical axes apply leaf for leaf. The launcher quantizes and dequantizes
eagerly, where the reference's division is exact: the scale is
``amax / 127 + 1e-12`` in fp32 and the codes ``round_half_even(x / s)``,
so codes and scales are bit-exact to the reference's.

(b) The int8 KV cache: int8 codes plus one scale per (batch, position,
head), as ``quantize_kv`` / ``dequantize_kv``. Rounding follows the
reference as its serving path runs them (inside a compiled program): the
scale is ``absmax * float32(1/127)`` (the compiler turns the division by
the constant 127 into that product), the codes are
``round_half_even(x / scale)`` with a true division by the computed
scale, clipped to +-127.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.nn.params import tree_map

INV_127 = float(np.float32(1.0) / np.float32(127.0))
# quantize leaves with at least this many elements (skip norms, biases)
MIN_QUANT_SIZE = 65_536


def should_quantize(leaf) -> bool:
    return (len(leaf.shape) >= 2 and
            math.prod(leaf.shape) >= MIN_QUANT_SIZE and
            leaf.dtype in (torch.bfloat16, torch.float32))


def _is_qt(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def quantize_params(params) -> Any:
    """bf16 param tree -> tree with big leaves replaced by {'q','s'}."""
    def one(leaf):
        if not should_quantize(leaf):
            return leaf
        xf = leaf.float()
        # a tensor divisor: a true division on either device (CUDA
        # multiplies by the reciprocal of a Python scalar divisor)
        s = xf.abs().amax() / torch.full((), 127.0, device=xf.device) + 1e-12
        q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        return {"q": q, "s": s}
    return tree_map(one, params)


def abstract_quantized(params_abs) -> Any:
    """The quantized tree's shapes on the ``meta`` device."""
    def one(leaf):
        if not should_quantize(leaf):
            return leaf
        return {"q": torch.empty(leaf.shape, dtype=torch.int8, device="meta"),
                "s": torch.empty((), dtype=torch.float32, device="meta")}
    return tree_map(one, params_abs)


def quantized_axes(params_abs, p_axes) -> Any:
    """Logical axes for the quantized tree (q inherits, s is replicated)."""
    def one(leaf, axes):
        if not should_quantize(leaf):
            return axes
        return {"q": axes, "s": ()}
    return tree_map(one, params_abs, p_axes)


def dequantize_params(qparams, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Reconstruct the model-dtype tree."""
    def walk(x):
        if _is_qt(x):
            return (x["q"].float() * x["s"]).to(dtype)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x
    return walk(qparams)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 codes [..., hd], f32 scales [...]).

    All-zero tiles get scale 1.0, not an epsilon: a tiny scale survives in
    f32 but underflows to 0.0 in the f16 scale planes the KV arena keeps,
    and a zero scale turns every later inverse into inf/NaN. A zero tile
    round-trips exactly under any positive scale."""
    xf = x.float()
    m = xf.abs().amax(-1)
    s = torch.where(m > 0, m * INV_127, torch.ones_like(m))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.float()[..., None]).to(dtype)
