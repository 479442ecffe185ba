"""CNetPlusScalar — CNN + scalar-context X-ray flux regressor (Miloshevich
et al., PyNets).

Multi-modal input: 256x256 2-channel solar imagery (HMI magnetogram +
AIA 193 A) plus the preceding 30-min background flux scalar, concatenated
into the first FC layer. ReLU replaces the original leaky-ReLU for DPU
compatibility (the original stays selectable). 3,050,485 params, ~0.92
GOP per sample (paper: 3,061,966 and 0.918 GOP).

The builder takes the widths as arguments so narrower CNet-shaped graphs
(for tests) come from the same code; the defaults are the published ones.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.opgraph import Graph
from repro_torch.models.common import (batch_synthetic, conv_same,
                                       init_graph_params, maxpool)

INPUT_SHAPE = (256, 256, 2)
CHANNELS = (48, 48, 32)
DENSE = 92


def build_graph(dpu_compatible: bool = True,
                input_shape: Tuple[int, int, int] = INPUT_SHAPE,
                channels: Sequence[int] = CHANNELS,
                dense: int = DENSE) -> Graph:
    """``dpu_compatible=False`` keeps the original leaky_relu activations."""
    act = "relu" if dpu_compatible else "leaky_relu"
    g = Graph("cnet_plus_scalar")
    x = g.input("image", tuple(input_shape))
    s = g.input("background_flux", (1,))
    for i, c in enumerate(channels):
        x = g.add("conv2d", [x], name=f"conv{i}", kernel=(3, 3), features=c,
                  stride=1, padding="SAME")
        x = g.add(act, [x], name=f"act{i}")
        x = g.add("maxpool2d", [x], name=f"pool{i}", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    x = g.add("concat", [x, s], name="concat_scalar", axis=0)
    x = g.add("dense", [x], name="fc1", features=dense)
    x = g.add("relu", [x], name="fc1_act")
    y = g.add("dense", [x], name="head", features=1)
    g.mark_output(y)
    return g


def torch_forward(params: Dict[str, Dict[str, torch.Tensor]],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CNetPlusScalar (the ReLU variant) as a plain batched PyTorch
    function over the graph's params (HWIO convs, [in, out] dense): the
    front-end's target. Output keys are the graph's output node names."""
    x = batch["image"]
    i = 0
    while f"conv{i}" in params:
        x = maxpool(F.relu(conv_same(x, params[f"conv{i}"])))
        i += 1
    x = x.reshape(x.shape[0], -1)
    x = torch.cat([x, batch["background_flux"]], dim=1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return {"head": x @ params["head"]["w"] + params["head"]["b"]}


def init_params(seed: int = 0, **widths):
    return init_graph_params(build_graph(**widths), seed)


def synthetic_input(rng: np.random.Generator,
                    input_shape: Tuple[int, int, int] = INPUT_SHAPE
                    ) -> Dict[str, np.ndarray]:
    """A solar disk: noisy magnetogram and a limb-darkened EUV channel."""
    h, w, _ = input_shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    disk = (r2 < 0.9).astype(np.float32)
    hmi = disk * rng.standard_normal((h, w), dtype=np.float32) * 0.3
    aia = (disk * np.exp(-3.0 * r2)
           + 0.02 * rng.standard_normal((h, w), dtype=np.float32))
    return {
        "image": np.stack([hmi, aia], axis=-1).astype(np.float32),
        "background_flux": np.array([3.0], np.float32),
    }


def synthetic_batch(rng: np.random.Generator, n: int,
                    input_shape: Tuple[int, int, int] = INPUT_SHAPE
                    ) -> Dict[str, np.ndarray]:
    return batch_synthetic(
        lambda r: synthetic_input(r, input_shape), rng, n)
