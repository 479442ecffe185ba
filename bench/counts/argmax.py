"""The argmax over ``size`` logits: one comparison per logit, as the graph
counts it; the logits read as float32, one int32 class written."""
from __future__ import annotations


def mac_ops(layer, batch: int) -> float:
    return 0.0


def ops(layer, batch: int) -> float:
    return float(batch * layer["size"])


def nbytes(layer, batch: int) -> float:
    return 4.0 * batch * (layer["size"] + 1)
