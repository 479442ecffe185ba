"""The VAE encoder (arXiv 2603.14091, Table I) in plain PyTorch: five SAME
3x3 stride-2 conv + ReLU stages over a 3-channel SHARP tile, the
flattened map (NHWC order) into the ``mu`` and ``logvar`` heads, and the
reparameterised sample ``mu + exp(logvar / 2) eps`` with ``eps`` drawn
from each request's key (``common.normal``).

``frames`` is the benchmark's frozen copy of the program's synthetic
active-region tile (a bipolar pair of gaussian blobs on noise), drawn on
the device from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.reference.common import normal

OUTPUTS = ("mu", "logvar", "sample")
INPUTS = ("image",)


def param_shapes(cfg) -> Dict[str, Dict[str, tuple]]:
    h, w, c = cfg["build_args"]["input_shape"]
    out, cin = {}, c
    for i, cout in enumerate(cfg["channels"]):
        out[f"conv{i}"] = {"w": (3, 3, cin, cout), "b": (cout,)}
        cin, h, w = cout, -(-h // 2), -(-w // 2)
    for head in ("mu", "logvar"):
        out[head] = {"w": (h * w * cin, cfg["latent"]), "b": (cfg["latent"],)}
    return out


def layers(cfg):
    h, w, c = cfg["build_args"]["input_shape"]
    out, cin = [], c
    for i, cout in enumerate(cfg["channels"]):
        out.append(dict(name=f"conv{i}", op="conv2d", precision="int8",
                        h=h, w=w, cin=cin, cout=cout, k=3, stride=2,
                        out_int8=True))
        h, w = -(-h // 2), -(-w // 2)
        out.append(dict(name=f"relu{i}", op="relu", precision="int8",
                        size=h * w * cout))
        cin = cout
    for head in ("mu", "logvar"):
        out.append(dict(name=head, op="dense", precision="int8",
                        k_in=h * w * cin, n=cfg["latent"], out_int8=False))
    out.append(dict(name="sample", op="sample_normal", precision="fp32",
                    size=cfg["latent"]))
    return out


def frames(gen: torch.Generator, n: int, cfg, device) -> Dict[str, torch.Tensor]:
    h, w, _ = cfg["build_args"]["input_shape"]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    cy, cx = h // 2, w // 2
    pos = torch.exp(-(((yy - cy) / 12.0) ** 2 + ((xx - cx + 30) / 18.0) ** 2))
    neg = -torch.exp(-(((yy - cy) / 15.0) ** 2 + ((xx - cx - 30) / 20.0) ** 2))
    field = pos + neg + 0.05 * torch.randn((n, h, w), generator=gen,
                                           device=device)
    return {"image": torch.stack([field, field.abs(), 0.5 * field], dim=-1)}


def forward(params, batch, layer, keys=None) -> Dict[str, torch.Tensor]:
    """``keys`` [B, 2] (numpy, uint32 values): each row's key for the
    sample; None leaves the sample out (calibration)."""
    x = batch["image"].float()
    i = 0
    while f"conv{i}" in params:
        x = torch.clamp_min(layer(f"conv{i}", x, 2), 0.0)
        i += 1
    flat = x.reshape(x.shape[0], -1)
    mu, logvar = layer("mu", flat), layer("logvar", flat)
    out = {"mu": mu, "logvar": logvar}
    if keys is not None:
        eps = torch.from_numpy(np.stack([normal(k, mu.shape[1])
                                         for k in keys]))
        out["sample"] = (mu.double() + torch.exp(0.5 * logvar.double())
                         * eps.to(mu.device)).float()
    return out
