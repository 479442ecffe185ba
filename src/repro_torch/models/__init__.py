"""The space use-case networks, as op graphs + params.

Only the networks the port serves so far are registered; the reference
registry (src/repro/models/__init__.py) holds all six.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import numpy as np

from repro_torch.models import cnet_plus_scalar


class SpaceModel(NamedTuple):
    name: str
    build_graph: Callable
    init_params: Callable           # seed -> params (CPU tensors)
    synthetic_input: Callable       # numpy Generator -> request dict
    synthetic_batch: Callable       # (numpy Generator, n) -> batch dict
    paper_params: int               # Table I
    paper_ops: int                  # Table I
    paper_toolchain: str            # which path the paper used


SPACE_MODELS: Dict[str, SpaceModel] = {
    "cnet_plus_scalar": SpaceModel(
        "cnet_plus_scalar", cnet_plus_scalar.build_graph,
        cnet_plus_scalar.init_params, cnet_plus_scalar.synthetic_input,
        cnet_plus_scalar.synthetic_batch,
        3_061_966, 918_241_400, "vitis_ai"),
}


def synthetic_requests(model: SpaceModel, n: int, seed: int = 0
                       ) -> List[Dict[str, np.ndarray]]:
    """``n`` independent synthetic request dicts as host numpy arrays, all
    drawn from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    return [model.synthetic_input(rng) for _ in range(n)]
