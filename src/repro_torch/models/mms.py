"""MMS neural networks — dayside plasma-region classifiers (Ekelund et al.
2024; BaselineNet originally Olshevsky et al. 2021).

Input: a 32x16x32 3-D ion energy distribution from the FPI instrument;
output: 4 classes (solar wind, ion foreshock, magnetosheath,
magnetopause) and their argmax. Three topologies:

* BaselineNet — 3-D convs + FC (918,625 params; paper 915,492).
* ReducedNet — pool first, a slim 3-D conv, FC (44,363; paper 44,624).
* LogisticNet — pool, flatten, linear (8,196, exact).

The final sigmoid is dropped (argmax-only classification). The 3-D convs
and pools are the op class the DPU analog lacks, so they run on the flex
path (PyTorch's ``conv3d``/``max_pool3d``); the dense layers are the
accel path's int8 kernels.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.opgraph import Graph
from repro_torch.models.common import batch_synthetic, init_graph_params

INPUT_SHAPE = (32, 16, 32, 1)
N_CLASSES = 4


def build_logistic_graph() -> Graph:
    g = Graph("logistic_net")
    x = g.input("dist", INPUT_SHAPE)
    x = g.add("maxpool3d", [x], name="pool", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    y = g.add("dense", [x], name="head", features=N_CLASSES)
    c = g.add("argmax", [y], name="region")
    g.mark_output(y, c)
    return g


def build_reduced_graph() -> Graph:
    g = Graph("reduced_net")
    x = g.input("dist", INPUT_SHAPE)
    x = g.add("maxpool3d", [x], name="pool0", kernel=2)
    x = g.add("conv3d", [x], name="conv0", kernel=(3, 3, 3), features=4,
              padding="SAME")
    x = g.add("relu", [x], name="act0")
    x = g.add("maxpool3d", [x], name="pool1", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    x = g.add("dense", [x], name="fc1", features=43)
    x = g.add("relu", [x], name="fc1_act")
    y = g.add("dense", [x], name="head", features=N_CLASSES)
    c = g.add("argmax", [y], name="region")
    g.mark_output(y, c)
    return g


def build_baseline_graph() -> Graph:
    g = Graph("baseline_net")
    x = g.input("dist", INPUT_SHAPE)
    x = g.add("conv3d", [x], name="conv0", kernel=(3, 3, 3), features=16,
              padding="SAME")
    x = g.add("relu", [x], name="act0")
    x = g.add("maxpool3d", [x], name="pool0", kernel=2)
    x = g.add("conv3d", [x], name="conv1", kernel=(3, 3, 3), features=48,
              padding="SAME")
    x = g.add("relu", [x], name="act1")
    x = g.add("maxpool3d", [x], name="pool1", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    x = g.add("dense", [x], name="fc1", features=73)
    x = g.add("relu", [x], name="fc1_act")
    y = g.add("dense", [x], name="head", features=N_CLASSES)
    c = g.add("argmax", [y], name="region")
    g.mark_output(y, c)
    return g


GRAPH_BUILDERS = {
    "logistic_net": build_logistic_graph,
    "reduced_net": build_reduced_graph,
    "baseline_net": build_baseline_graph,
}


def init_params(name: str, seed: int = 0
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    return init_graph_params(GRAPH_BUILDERS[name](), seed)


def synthetic_input(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A synthetic FPI distribution: an anisotropic beam (solar-wind-like)
    plus a uniform thermal background."""
    e, t, p = np.mgrid[0:32, 0:16, 0:32].astype(np.float32)
    beam = np.exp(-((e - 10.0) ** 2 / 8.0 + (t - 8.0) ** 2 / 6.0
                    + (p - 16.0) ** 2 / 10.0))
    background = 0.05 * rng.uniform(size=(32, 16, 32)).astype(np.float32)
    return {"dist": (beam + background)[..., None].astype(np.float32)}


def synthetic_batch(rng: np.random.Generator, n: int
                    ) -> Dict[str, np.ndarray]:
    return batch_synthetic(synthetic_input, rng, n)
