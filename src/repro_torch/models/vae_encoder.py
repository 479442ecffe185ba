"""VAE encoder — a probabilistic conv encoder for SHARP magnetogram tiles.

128x256 RGB tiles -> a 6-element latent (1:16,384 compression). Five
stride-2 conv+ReLU stages, then the mu / logvar heads and the
reparameterised sample ``z = mu + exp(0.5 logvar) * eps``, which the
inspector keeps on the flex path (the paper runs exactly that tail on
the CPU). eps is drawn per sample from the plan's seed pairs
(``kernels/sample.py``). Channels 8/32/96/144/144: 396,940 params (paper
Table I: 395,692).

The builder takes the input shape as an argument so narrower
VAE-shaped graphs (for tests) come from the same code; the default is the
published one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.opgraph import Graph
from repro_torch.models.common import batch_synthetic, init_graph_params

INPUT_SHAPE = (128, 256, 3)
LATENT = 6
CHANNELS = (8, 32, 96, 144, 144)


def build_graph(input_shape: Tuple[int, int, int] = INPUT_SHAPE) -> Graph:
    g = Graph("vae_encoder")
    x = g.input("image", tuple(input_shape))
    for i, c in enumerate(CHANNELS):
        x = g.add("conv2d", [x], name=f"conv{i}", kernel=(3, 3), features=c,
                  stride=2, padding="SAME")
        x = g.add("relu", [x], name=f"relu{i}")
    x = g.add("flatten", [x], name="flatten")
    mu = g.add("dense", [x], name="mu", features=LATENT)
    logvar = g.add("dense", [x], name="logvar", features=LATENT)
    z = g.add("sample_normal", [mu, logvar], name="sample")
    g.mark_output(mu, logvar, z)
    return g


def init_params(seed: int = 0,
                input_shape: Tuple[int, int, int] = INPUT_SHAPE):
    return init_graph_params(build_graph(input_shape), seed)


def synthetic_input(rng: np.random.Generator,
                    input_shape: Tuple[int, int, int] = INPUT_SHAPE
                    ) -> Dict[str, np.ndarray]:
    """A synthetic active-region tile: a bipolar pair of gaussian blobs
    (a sunspot pair) on a noisy background."""
    h, w, _ = input_shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h // 2, w // 2
    pos = np.exp(-(((yy - cy) / 12.0) ** 2 + ((xx - cx + 30) / 18.0) ** 2))
    neg = -np.exp(-(((yy - cy) / 15.0) ** 2 + ((xx - cx - 30) / 20.0) ** 2))
    field = (pos + neg
             + 0.05 * rng.standard_normal((h, w), dtype=np.float32))
    img = np.stack([field, np.abs(field), 0.5 * field], axis=-1)
    return {"image": img.astype(np.float32)}


def synthetic_batch(rng: np.random.Generator, n: int,
                    input_shape: Tuple[int, int, int] = INPUT_SHAPE
                    ) -> Dict[str, np.ndarray]:
    return batch_synthetic(
        lambda r: synthetic_input(r, input_shape), rng, n)
