"""A ``k x k x k`` max-pool (VALID, stride ``k``) with ``size`` outputs:
one comparison per window element, as the graph counts it; each input
read once and each output written once, as float32."""
from __future__ import annotations


def mac_ops(layer, batch: int) -> float:
    return 0.0


def ops(layer, batch: int) -> float:
    return float(batch * layer["size"] * layer["k"] ** 3)


def nbytes(layer, batch: int) -> float:
    return 4.0 * batch * layer["size"] * (layer["k"] ** 3 + 1)
