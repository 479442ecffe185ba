"""CNet+Scalar (arXiv 2603.14091, Table I; Miloshevich et al.) in plain
PyTorch: three SAME 3x3 conv + ReLU + 2x2 max-pool stages over a 2-channel
solar image, the flattened map (NHWC order) joined by the background-flux
scalar, a dense + ReLU layer and a one-unit regression head.

``frames`` is the benchmark's frozen copy of the program's synthetic
solar disk (a noisy magnetogram beside a limb-darkened EUV channel),
drawn on the device from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench.reference.common import maxpool2

OUTPUTS = ("head",)
INPUTS = ("image", "background_flux")


def param_shapes(cfg) -> Dict[str, Dict[str, tuple]]:
    h, w, c = cfg["build_args"]["input_shape"]
    chans = cfg["build_args"]["channels"]
    out = {}
    cin = c
    for i, cout in enumerate(chans):
        out[f"conv{i}"] = {"w": (3, 3, cin, cout), "b": (cout,)}
        cin = cout
        h, w = h // 2, w // 2
    dense = cfg["build_args"]["dense"]
    out["fc1"] = {"w": (h * w * cin + 1, dense), "b": (dense,)}
    out["head"] = {"w": (dense, 1), "b": (1,)}
    return out


def layers(cfg):
    """The served layers in order, with the precision each runs in on the
    int8 plan and whether its output leaves as int8 codes."""
    h, w, c = cfg["build_args"]["input_shape"]
    chans = cfg["build_args"]["channels"]
    out, cin = [], c
    for i, cout in enumerate(chans):
        last = i == len(chans) - 1
        out.append(dict(name=f"conv{i}", op="conv2d", precision="int8",
                        h=h, w=w, cin=cin, cout=cout, k=3, stride=1,
                        out_int8=not last))
        out.append(dict(name=f"act{i}", op="relu", precision="int8",
                        size=h * w * cout))
        out.append(dict(name=f"pool{i}", op="maxpool2d", precision="fp32",
                        size=(h // 2) * (w // 2) * cout, k=2))
        cin, h, w = cout, h // 2, w // 2
    dense = cfg["build_args"]["dense"]
    out.append(dict(name="fc1", op="dense", precision="int8",
                    k_in=h * w * cin + 1, n=dense, out_int8=True))
    out.append(dict(name="fc1_act", op="relu", precision="int8", size=dense))
    out.append(dict(name="head", op="dense", precision="int8", k_in=dense,
                    n=1, out_int8=False))
    return out


def frames(gen: torch.Generator, n: int, cfg, device) -> Dict[str, torch.Tensor]:
    h, w, _ = cfg["build_args"]["input_shape"]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    r2 = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    disk = (r2 < 0.9).float()
    noise = torch.randn((n, 2, h, w), generator=gen, device=device)
    hmi = disk * noise[:, 0] * 0.3
    aia = disk * torch.exp(-3.0 * r2) + 0.02 * noise[:, 1]
    return {"image": torch.stack([hmi, aia], dim=-1),
            "background_flux": torch.full((n, 1), 3.0, device=device)}


def forward(params, batch, layer, keys=None) -> Dict[str, torch.Tensor]:
    """``layer(name, x, stride)`` runs one conv (NHWC) or dense layer."""
    x = batch["image"].float()
    i = 0
    while f"conv{i}" in params:
        x = maxpool2(torch.clamp_min(layer(f"conv{i}", x), 0.0))
        i += 1
    flat = x.reshape(x.shape[0], -1)
    flat = torch.cat([flat, batch["background_flux"].float()], dim=1)
    hid = torch.clamp_min(layer("fc1", flat), 0.0)
    return {"head": layer("head", hid)}
