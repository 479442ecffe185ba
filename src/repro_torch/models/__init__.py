"""The paper's six space use-case networks, as op graphs + params.

Registry keys match the paper's Table I rows, in the reference's order
(src/repro/models/__init__.py). ``synthetic_batch`` yields ``[n, ...]``
stacked inputs for the engine's batched execution plans.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np

from repro_torch.models import cnet_plus_scalar, esperta, mms, vae_encoder


class SpaceModel(NamedTuple):
    name: str
    build_graph: Callable
    init_params: Callable           # seed -> params (CPU tensors)
    synthetic_input: Callable       # numpy Generator -> request dict
    synthetic_batch: Callable       # (numpy Generator, n) -> batch dict
    paper_params: int               # Table I
    paper_ops: int                  # Table I
    paper_toolchain: str            # which path the paper used
    # the same network as a plain batched PyTorch function
    # ``(params, batch) -> {output_name: tensor}`` over the graph's
    # params: the torch.fx front-end's target (repro_torch.frontend.trace)
    torch_forward: Callable


SPACE_MODELS: Dict[str, SpaceModel] = {
    "vae_encoder": SpaceModel(
        "vae_encoder", vae_encoder.build_graph, vae_encoder.init_params,
        vae_encoder.synthetic_input, vae_encoder.synthetic_batch,
        395_692, 83_417_100, "vitis_ai", vae_encoder.torch_forward),
    "cnet_plus_scalar": SpaceModel(
        "cnet_plus_scalar", cnet_plus_scalar.build_graph,
        cnet_plus_scalar.init_params, cnet_plus_scalar.synthetic_input,
        cnet_plus_scalar.synthetic_batch,
        3_061_966, 918_241_400, "vitis_ai", cnet_plus_scalar.torch_forward),
    "multi_esperta": SpaceModel(
        "multi_esperta", esperta.build_graph, esperta.init_params,
        esperta.synthetic_input, esperta.synthetic_batch, 24, 60, "hls",
        esperta.torch_forward),
    "logistic_net": SpaceModel(
        "logistic_net", mms.build_logistic_graph,
        lambda seed: mms.init_params("logistic_net", seed),
        mms.synthetic_input, mms.synthetic_batch, 8_196, 30_720, "hls",
        mms.torch_forward_logistic),
    "reduced_net": SpaceModel(
        "reduced_net", mms.build_reduced_graph,
        lambda seed: mms.init_params("reduced_net", seed),
        mms.synthetic_input, mms.synthetic_batch, 44_624, 502_961, "hls",
        mms.torch_forward_reduced),
    "baseline_net": SpaceModel(
        "baseline_net", mms.build_baseline_graph,
        lambda seed: mms.init_params("baseline_net", seed),
        mms.synthetic_input, mms.synthetic_batch,
        915_492, 110_541_696, "hls", mms.torch_forward_baseline),
}


def synthetic_requests(model: SpaceModel, n: int, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    """``n`` independent synthetic request dicts as host numpy arrays, all
    drawn from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return [model.synthetic_input(rng) for _ in range(n)]
