"""Carry state from numpy arrays into the port.

The reference package and the port draw different random numbers from
the same seed, so anything both must compute on — parameters, calibration
state — is handed over as numpy arrays. Layouts stay the reference's:
HWIO conv weights, [K, N] dense weights; the large-model stack's param and
cache trees keep the reference's nested keys and stacked layer dims, and
its train state the reference's ``TrainState(params, AdamWState)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import TrainState
from repro_torch.optim.adamw import AdamWState


@dataclasses.dataclass
class Calibration:
    """PTQ calibration state an engine can adopt (``Engine.load_calibration``):
    per-node activation absmax and PTQ error ratios. The adopting engine
    quantizes its own weights (bit-identical to the reference's codes)."""
    act_absmax: Dict[str, float]
    ptq_err: Dict[str, float]


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(params_np: Mapping[str, Mapping[str, np.ndarray]],
                      device: DeviceLike = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{node: {name: array}}`` -> the same dict of tensors on ``device``."""
    dev = resolve_device(device)
    return {node: {k: _tensor(v, dev) for k, v in p.items()}
            for node, p in params_np.items()}


def calibration_from_numpy(act_absmax: Mapping[str, float],
                           ptq_err: Mapping[str, float],
                           device: DeviceLike = None) -> Calibration:
    """Calibration state as the port holds it: Python floats keyed by node.
    ``device`` is checked like every entry point's (the card unless the
    caller asks for the CPU)."""
    resolve_device(device)
    return Calibration({k: float(v) for k, v in act_absmax.items()},
                       {k: float(v) for k, v in ptq_err.items()})


def tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A nested dict of numpy arrays (the reference's ``nn`` param or
    cache tree) -> the same dict of tensors on ``device``. A bfloat16
    array (numpy has no bf16 of its own: the reference's arrays carry an
    extension dtype named ``bfloat16``) crosses as its uint16 bits, so
    this module needs no package that defines the dtype."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return _tensor(a, dev)


def train_state_from_numpy(state: Any, device: DeviceLike = None
                           ) -> TrainState:
    """The reference's ``TrainState(params, AdamWState(step, m, v,
    master))`` with numpy leaves (``jax.tree.map(np.asarray, state)``) ->
    the port's, on ``device``: bf16 params, fp32 moments and master
    weights, the int32 step."""
    params, opt = state
    return TrainState(tree_from_numpy(params, device), AdamWState(
        *(tree_from_numpy(x, device) for x in opt)))
