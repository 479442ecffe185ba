"""Shared param init for op-graph models (He/LeCun init per op type) and
batched synthetic-input stacking.

Parameters and inputs are drawn from numpy generators seeded by the
caller: the formulas are the reference's, the numbers are numpy's.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.opgraph import Graph


def batch_synthetic(synthetic_input: Callable, rng: np.random.Generator,
                    n: int) -> Dict[str, np.ndarray]:
    """Stack ``n`` independent synthetic samples into ``[n, ...]`` host
    arrays (the layout the engine's batched plans consume)."""
    samples = [synthetic_input(rng) for _ in range(n)]
    return {name: np.stack([s[name] for s in samples])
            for name in samples[0]}


def _normal(rng: np.random.Generator, shape, std: float) -> torch.Tensor:
    w = rng.standard_normal(shape, dtype=np.float32) * np.float32(std)
    return torch.from_numpy(w)


def init_graph_params(g: Graph, seed: int
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal conv weights (HWIO; DHWIO for conv3d), LeCun-normal dense
    weights ([K, N]), zero biases and SSD decay rates ``A = -uniform(0.5,
    1.5)`` per head, drawn in graph order from ``seed``. CPU tensors: the
    engine moves them to its device."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in g.order:
        node = g.nodes[name]
        if node.op == "conv2d":
            kh, kw = node.attrs["kernel"]
            cin = g.nodes[node.inputs[0]].out_shape[-1]
            cin_g = cin // node.attrs.get("groups", 1)
            cout = node.attrs["features"]
            params[name] = {
                "w": _normal(rng, (kh, kw, cin_g, cout),
                             (2.0 / (kh * kw * cin_g)) ** 0.5),
                "b": torch.zeros(cout)}
        elif node.op == "dense":
            in_shape = g.nodes[node.inputs[0]].out_shape
            fin = (int(in_shape[-1]) if node.attrs.get("per_position")
                   else int(np.prod(in_shape)))
            fout = node.attrs["features"]
            p = {"w": _normal(rng, (fin, fout), (1.0 / fin) ** 0.5)}
            if node.attrs.get("bias", True):
                p["b"] = torch.zeros(fout)
            params[name] = p
        elif node.op == "ssd":
            # per-head decay rate A [H], negative so exp(dt*A) < 1 for
            # dt > 0 (bounded state): the Mamba-2 initialization range
            h = int(g.nodes[node.inputs[0]].out_shape[-2])
            params[name] = {"A": torch.from_numpy(
                -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32))}
        elif node.op == "conv3d":
            kd, kh, kw = node.attrs["kernel"]
            cin = g.nodes[node.inputs[0]].out_shape[-1]
            cout = node.attrs["features"]
            params[name] = {
                "w": _normal(rng, (kd, kh, kw, cin, cout),
                             (2.0 / (kd * kh * kw * cin)) ** 0.5),
                "b": torch.zeros(cout)}
    return params
