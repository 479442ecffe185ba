"""Front-end demo: a depthwise-separable cloud-mask CNN that exists only
as a PyTorch function (no hand-built graph anywhere in models/), going
trace -> inspect -> PTQ -> autotune -> scheduler serve end to end.

The model is a CloudScout-style cloud screening net (the classic
on-board selective-downlink use case: discard cloudy tiles before they
reach the radio): multispectral 48x48x4 tiles through a strided stem
conv and two depthwise-separable blocks, ending in a cloud probability
plus a thresholded discard flag. Depthwise convs exercise the grouped
conv path the hand-built nets never touch: the inspector routes them to
flex (no int8 grouped kernel) while the pointwise 1x1 and dense layers
quantize onto the accel path, a partial-offload split the tracer has to
get right for the serve to work at all.

Weights and tiles come from numpy generators; the layer names, shapes
and init formulas are the reference demo's (src/repro/frontend/demo.py),
so its weights and tiles can be handed over as arrays.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.frontend.trace import TracedModel, trace
from repro_torch.models.common import conv_same, maxpool

INPUT_SHAPE = (48, 48, 4)          # 4-band multispectral tile
CHANNELS = (16, 32, 64)            # stem, block1 pointwise, block2 pointwise
DENSE = 32
CLOUD_THRESHOLD = 0.5


def init_params(seed: int = 42) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-init weights keyed by the function's layer names (HWIO convs,
    [in, out] dense); the tracer rebinds them under traced node names."""
    rng = np.random.default_rng(seed)
    shapes = {
        "stem": (3, 3, INPUT_SHAPE[-1], CHANNELS[0]),
        "dw1": (3, 3, 1, CHANNELS[0]),
        "pw1": (1, 1, CHANNELS[0], CHANNELS[1]),
        "dw2": (3, 3, 1, CHANNELS[1]),
        "pw2": (1, 1, CHANNELS[1], CHANNELS[2]),
    }
    fin = (INPUT_SHAPE[0] // 8) * (INPUT_SHAPE[1] // 8) * CHANNELS[2]
    std = {name: (2.0 / (s[0] * s[1] * s[2])) ** 0.5
           for name, s in shapes.items()}
    shapes.update(fc1=(fin, DENSE), score=(DENSE, 1))
    std.update(fc1=(1.0 / fin) ** 0.5, score=(1.0 / DENSE) ** 0.5)
    return {name: {
        "w": torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                              * np.float32(std[name])),
        "b": torch.zeros(s[-1])} for name, s in shapes.items()}


def torch_forward(params: Dict[str, Dict[str, torch.Tensor]],
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    x = F.relu(conv_same(batch["bands"], params["stem"], stride=2))
    for i, (dw, pw) in enumerate((("dw1", "pw1"), ("dw2", "pw2"))):
        x = F.relu(conv_same(x, params[dw], groups=CHANNELS[i]))
        x = F.relu(conv_same(x, params[pw]))
        x = maxpool(x)
    x = x.reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    score = x @ params["score"]["w"] + params["score"]["b"]
    prob = torch.sigmoid(score)
    return {"cloud_prob": prob,
            "cloud_flag": (prob > CLOUD_THRESHOLD).float()}


def build_traced(seed: int = 42, params=None) -> TracedModel:
    """The demo traced from ``torch_forward`` over ``params`` (drawn from
    ``seed`` when None)."""
    params = init_params(seed) if params is None else params
    return trace(functools.partial(torch_forward, params),
                 {"bands": INPUT_SHAPE}, name="cloud_mask_cnn")


def synthetic_input(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A synthetic tile: cumulus-like bright blobs over a dark surface,
    correlated across the four bands."""
    h, w, _ = INPUT_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = rng.uniform(8.0, h - 8.0, size=(3, 1, 1)).astype(np.float32)
    cx = rng.uniform(8.0, w - 8.0, size=(3, 1, 1)).astype(np.float32)
    blobs = np.sum(np.exp(-(((yy - cy) / 6.0) ** 2
                            + ((xx - cx) / 7.0) ** 2)), axis=0)
    base = 0.1 + 0.05 * rng.standard_normal((h, w), dtype=np.float32)
    gains = np.asarray([1.0, 0.9, 0.8, 1.2], np.float32)
    tile = base[..., None] + blobs[..., None] * gains
    return {"bands": tile.astype(np.float32)}


def synthetic_requests(n: int, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [synthetic_input(rng) for _ in range(n)]


def keep_predicate(out: Dict[str, np.ndarray]) -> bool:
    """Selective downlink: cloudy tiles are discarded on board."""
    return float(np.max(out["cloud_flag"])) < 0.5


def run_demo(n_requests: int = 32, rate_hz: float = 256.0,
             batch_top: int = 8, autotune: bool = True,
             backends=("accel", "flex"), verbose: bool = True,
             device=None) -> Dict:
    """The full front-end pipeline on the never-hand-built model: trace
    -> inspect -> PTQ calibrate -> autotune -> serve a Poisson trace
    through the continuous-batching scheduler (on the card unless
    ``device="cpu"``). Returns the facts the demo's checks assert on,
    with the scheduler and engine under ``"scheduler"``/``"engine"``."""
    from repro_torch.core import inspector
    from repro_torch.core.engine import Engine
    from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                            capped_ladder, poisson_arrivals)
    tm = build_traced()
    report = inspector.inspect(tm.graph)
    if verbose:
        print(tm.graph.summary())
        print(report.summary())
    engine = Engine(tm.graph, tm.params, autotune=autotune, device=device)
    reqs = synthetic_requests(n_requests, seed=11)
    if "accel" in backends:
        engine.calibrate(reqs[:4])
    sched = ContinuousBatchingScheduler(clock="modeled")
    sched.register("cloud_mask_cnn", engine, backend=backends,
                   ladder=capped_ladder(batch_top),
                   keep_predicate=keep_predicate, warmup_sample=reqs[0])
    arrivals = poisson_arrivals(rate_hz, n_requests, seed=5)
    sched.serve_trace([(t, "cloud_mask_cnn", r)
                       for t, r in zip(arrivals, reqs)])
    if verbose:
        print(sched.summary())
    kept = sum(1 for c in sched.completions if c.kept)
    return {
        "graph_nodes": len(tm.graph.order),
        "mac_coverage": report.mac_coverage,
        "n_segments": len(report.segments),
        "fully_supported": report.fully_supported,
        "n_requests": n_requests,
        "n_completed": len(sched.completions),
        "n_kept": kept,
        "outputs": sorted(tm.graph.outputs),
        "scheduler": sched,
        "engine": engine,
    }
