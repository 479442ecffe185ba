"""Shared fused-epilogue math for the int8 kernels' plain versions.

One definition of the post-accumulator tail that ``int8_matmul`` and
``conv2d_int8`` apply, so the plain PyTorch versions and the CUDA kernels
(``csrc/*.cu``) agree on every rounding step:

    int32 acc -> fp32 dequant -> (+bias) -> act -> (requantize to int8)

The arithmetic repeats what the reference computes on its XLA backend,
which was established by probing it:

* the bias add is fused with the last dequant multiply into ONE rounding
  (a fused multiply-add), so ``fma_f32`` below is exact float32 FMA;
* division by a static scale is rewritten as multiplication by the
  float32 reciprocal of the scale, so the requantize step and the
  activation quantizer compute ``rint(x * (1/s))`` (``reciprocal_f32``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ACTS = ("relu", "sigmoid")


def normalize_act(relu: bool, act: Optional[str]) -> Optional[str]:
    """The kernels take ``relu: bool`` or ``act``; both set is a misuse."""
    if act is not None:
        if relu:
            raise ValueError("pass either relu=True or act=..., not both")
        if act not in ACTS:
            raise ValueError(f"unsupported epilogue act {act!r}")
        return act
    return "relu" if relu else None


def out_dtype_for(requant_scale: Optional[float],
                  default: torch.dtype = torch.float32) -> torch.dtype:
    return torch.int8 if requant_scale is not None else default


def pad_channel_params(w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                       n_pad: int):
    """Extend per-output-channel dequant params to a padded channel count:
    scale 1.0 and bias 0.0 on the padding channels (neutral, finite)."""
    if n_pad == 0:
        return w_scale, bias
    w_scale = torch.nn.functional.pad(w_scale, (0, n_pad), value=1.0)
    if bias is not None:
        bias = torch.nn.functional.pad(bias, (0, n_pad))
    return w_scale, bias


def f32(scale: float) -> float:
    """A Python scale rounded to float32 (the width it has where it meets a
    tensor), returned as a Python float that float32 holds exactly."""
    return float(np.float32(scale))


def reciprocal_f32(scale: float) -> float:
    """float32(1 / float32(scale)), correctly rounded."""
    return float(np.float32(1.0) / np.float32(scale))


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Static-scale activation quantizer: ``clip(rint(x * (1/s)))`` int8."""
    inv = reciprocal_f32(scale)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``fma(a, b, c)``: one rounding of ``a*b + c``.

    The float64 product of two float32 values is exact; the float64 sum is
    then rounded to odd (its error term, from TwoSum, decides the nudge),
    and rounding that to float32 is the correctly rounded result since
    float64 carries more than 24 + 2 significand bits."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.float()


def dequant_bias(acc: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor],
                 pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``f32(acc) [* pre] * scale (+ bias)``: every multiply rounds to
    float32, and the bias add fuses with the LAST multiply."""
    out = acc.float()
    if pre is not None:
        out = out * pre
    if bias is None:
        return out * scale
    return fma_f32(out, scale.expand_as(out), bias.expand_as(out))


def apply_epilogue(out: torch.Tensor, act: Optional[str],
                   requant_scale: Optional[float]) -> torch.Tensor:
    """The fp32 tail after dequant+bias: act, then the optional int8
    requantize at ``requant_scale`` (returned as int8)."""
    if act == "relu":
        out = torch.clamp_min(out, 0.0)
    elif act == "sigmoid":
        out = torch.sigmoid(out)
    if requant_scale is not None:
        return quantize_act(out, requant_scale)
    return out
