"""The MMS BaselineNet (arXiv 2603.14091, Table I; Olshevsky et al. 2021,
Ekelund et al. 2024) in plain PyTorch: two SAME 3x3x3 conv3d + ReLU +
2x2x2 max-pool stages over a 32x16x32x1 FPI ion energy distribution
(NDHWC), the flattened map (NDHWC order) into a dense + ReLU layer and a
four-unit head. The final sigmoid is dropped and the class is the argmax
of the head, as in the program; the check compares the head's logits.

The 3-D stages run in float32 outside the ``layer`` callback, as the
program's flex segments run them (the DPU has no 3-D layers), so only
``fc1`` and ``head`` are quantized and only they meet the demotion gate.
Departures from the program:

- ``fc1`` and ``head`` sum their integer codes exactly in float64 and
  dequantize in float64 (``common.Quantized.serving``); the program sums
  in int32 (also exact) and dequantizes in float32.
- The convolutions are the library's float32 ``conv3d`` on the same
  padded, channels-first views as the program's, with TF32 off (the
  space system's check turns it off); the bias is added after the
  convolution, as in the program. Where the library picks another
  algorithm for the two calls, the sums run in another order.
- ReLU and the max-pool are exact in any order.

``frames`` is the benchmark's frozen copy of the program's synthetic FPI
distribution (an anisotropic beam plus a uniform background at 0.05),
drawn on the device from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference.common import conv3d

OUTPUTS = ("head",)
INPUTS = ("dist",)
POOL = 2        # each max-pool's window and stride, on every axis


def _stages(cfg):
    """(d, h, w, cin, cout) of each 3-D stage's convolution."""
    sh = cfg["shape"]
    d, h, w, cin = sh["input"]
    out = []
    for cout in sh["conv_channels"]:
        out.append((d, h, w, cin, cout))
        d, h, w, cin = d // POOL, h // POOL, w // POOL, cout
    return out, d * h * w * cin


def param_shapes(cfg) -> Dict[str, Dict[str, tuple]]:
    sh = cfg["shape"]
    k = sh["kernel"]
    stages, flat = _stages(cfg)
    out = {f"conv{i}": {"w": (k, k, k, cin, cout), "b": (cout,)}
           for i, (_, _, _, cin, cout) in enumerate(stages)}
    out["fc1"] = {"w": (flat, sh["dense"]), "b": (sh["dense"],)}
    out["head"] = {"w": (sh["dense"], sh["classes"]), "b": (sh["classes"],)}
    return out


def layers(cfg):
    """The served layers in order, with the precision each runs in on the
    int8 plan and whether its output leaves as int8 codes."""
    sh = cfg["shape"]
    k, p = sh["kernel"], POOL
    stages, flat = _stages(cfg)
    out = []
    for i, (d, h, w, cin, cout) in enumerate(stages):
        out.append(dict(name=f"conv{i}", op="conv3d", precision="fp32",
                        d=d, h=h, w=w, cin=cin, cout=cout, k=k, stride=1))
        out.append(dict(name=f"act{i}", op="relu", precision="fp32",
                        size=d * h * w * cout))
        out.append(dict(name=f"pool{i}", op="maxpool3d", precision="fp32",
                        size=(d // p) * (h // p) * (w // p) * cout, k=p))
    out.append(dict(name="fc1", op="dense", precision="int8", k_in=flat,
                    n=sh["dense"], out_int8=True))
    out.append(dict(name="fc1_act", op="relu", precision="int8",
                    size=sh["dense"]))
    out.append(dict(name="head", op="dense", precision="int8",
                    k_in=sh["dense"], n=sh["classes"], out_int8=False))
    out.append(dict(name="region", op="argmax", precision="fp32",
                    size=sh["classes"]))
    return out


def frames(gen: torch.Generator, n: int, cfg, device) -> Dict[str, torch.Tensor]:
    d, h, w, _ = cfg["shape"]["input"]
    e, t, p = torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=device)
          for s in (d, h, w)), indexing="ij")
    beam = torch.exp(-((e - 10.0) ** 2 / 8.0 + (t - 8.0) ** 2 / 6.0
                       + (p - 16.0) ** 2 / 10.0))
    background = 0.05 * torch.rand((n, d, h, w), generator=gen,
                                   device=device)
    return {"dist": (beam + background).unsqueeze(-1)}


def maxpool3(x: torch.Tensor) -> torch.Tensor:
    """The max-pool, window and stride ``POOL`` on each axis, of NDHWC
    ``x``."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), POOL, POOL)
    return y.permute(0, 2, 3, 4, 1)


def forward(params, batch, layer, keys=None) -> Dict[str, torch.Tensor]:
    """The 3-D stages in float32; ``layer(name, x)`` runs ``fc1`` and
    ``head``."""
    x = batch["dist"].float()
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        y = conv3d(x, p["w"].float(), 1) + p["b"].float()
        x = maxpool3(torch.clamp_min(y, 0.0))
        i += 1
    hid = torch.clamp_min(layer("fc1", x.reshape(x.shape[0], -1)), 0.0)
    return {"head": layer("head", hid)}
