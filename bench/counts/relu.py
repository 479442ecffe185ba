"""A ReLU of ``size`` elements. In the int8 plan it runs in its
producer's epilogue, so it moves no bytes of its own."""
from __future__ import annotations


def mac_ops(layer, batch: int) -> float:
    return 0.0


def ops(layer, batch: int) -> float:
    return float(batch * layer["size"])


def nbytes(layer, batch: int) -> float:
    return 0.0
