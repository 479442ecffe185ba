"""ESPERTA / multi-ESPERTA — Solar Energetic Particle event prediction
(Laurenza et al. 2009; Alberti et al. 2017).

Each ESPERTA model is a 3-input logistic threshold unit over (flare
heliolongitude, time-integrated soft X-ray flux, time-integrated ~1 MHz
radio flux): p = sigmoid(w.x + b); warn = p > threshold. Multi-ESPERTA
packs six such models with different weights and thresholds behind a
shared input: 24 params, ~60 ops. The weights are the published
constants (one (w, b, threshold) set per heliolongitude/flux regime), not
trained and not drawn.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.opgraph import Graph
from repro_torch.models.common import batch_synthetic

N_MODELS = 6

# logistic coefficients per regime (w_lon, w_sxr, w_radio, bias) and the
# decision threshold, at the published 10-minute-warning operating point
WEIGHTS = np.array([
    [0.012, 1.10, 0.85, -2.10],
    [0.010, 1.25, 0.70, -1.95],
    [0.015, 0.95, 0.95, -2.30],
    [0.008, 1.40, 0.60, -1.80],
    [0.013, 1.05, 0.80, -2.05],
    [0.011, 1.15, 0.75, -2.00],
], np.float32)
THRESHOLDS = np.array([0.50, 0.45, 0.55, 0.40, 0.50, 0.48], np.float32)


def build_graph(n_models: int = N_MODELS) -> Graph:
    g = Graph("multi_esperta")
    x = g.input("features", (3,))
    for m in range(n_models):
        z = g.add("dense", [x], name=f"logit{m}", features=1)
        p = g.add("sigmoid", [z], name=f"prob{m}")
        w = g.add("greater", [p], name=f"warn{m}",
                  threshold=float(THRESHOLDS[m]))
        g.mark_output(p, w)
    return g


def build_single_graph(m: int = 0) -> Graph:
    """One ESPERTA model (the paper's sequential original)."""
    g = Graph(f"esperta_{m}")
    x = g.input("features", (3,))
    z = g.add("dense", [x], name="logit", features=1)
    p = g.add("sigmoid", [z], name="prob")
    w = g.add("greater", [p], name="warn", threshold=float(THRESHOLDS[m]))
    g.mark_output(p, w)
    return g


def init_params(seed=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The published weights; ``seed`` is ignored (nothing is drawn)."""
    del seed
    return {f"logit{m}": {"w": torch.from_numpy(WEIGHTS[m, :3][:, None]),
                          "b": torch.from_numpy(WEIGHTS[m, 3:4].copy())}
            for m in range(N_MODELS)}


def sequential_reference(inputs: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """The paper's original formulation: six ESPERTA models invoked one
    after another (numpy, float64 logit)."""
    x = np.asarray(inputs["features"], np.float32)
    out: Dict[str, np.ndarray] = {}
    for m in range(N_MODELS):
        z = float(x @ WEIGHTS[m, :3] + WEIGHTS[m, 3])
        p = 1.0 / (1.0 + np.exp(-z))
        out[f"prob{m}"] = np.asarray([p], np.float32)
        out[f"warn{m}"] = np.asarray([p > THRESHOLDS[m]], np.float32)
    return out


def synthetic_input(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Heliolongitude in [-90, 90] deg, log-integrated SXR flux in
    [0.5, 3.0], log-integrated radio flux in [0.3, 2.5]."""
    lon = rng.uniform(-90.0, 90.0)
    sxr = rng.uniform(0.5, 3.0)
    radio = rng.uniform(0.3, 2.5)
    return {"features": np.array([lon, sxr, radio], np.float32)}


def synthetic_batch(rng: np.random.Generator, n: int
                    ) -> Dict[str, np.ndarray]:
    return batch_synthetic(synthetic_input, rng, n)
