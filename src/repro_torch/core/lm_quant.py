"""The int8 KV cache's quantizer: int8 codes plus one scale per
(batch, position, head), as the reference's ``lm_quant.quantize_kv`` /
``dequantize_kv`` (src/repro/core/lm_quant.py). The weight-PTQ tree
functions of that module belong to the large-model stack, not ported yet.

Rounding follows the reference as its serving path runs it (inside a
compiled program): the scale is ``absmax * float32(1/127)`` (the compiler
turns the division by the constant 127 into that product), the codes are
``round_half_even(x / scale)`` with a true division by the computed
scale, clipped to +-127.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INV_127 = float(np.float32(1.0) / np.float32(127.0))


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
