"""A dense layer: ``k_in`` in, ``n`` out. The arithmetic and byte count
of ``chip_smoke.py``'s ``int8_matmul`` phases: the activations, the
``[k_in, n]`` weights, a scale per row and a scale and bias per column
read once, the output written once (1 byte as int8 codes, else 4)."""
from __future__ import annotations


def mac_ops(layer, batch: int) -> float:
    return 2.0 * batch * layer["k_in"] * layer["n"]


def ops(layer, batch: int) -> float:
    """Multiply-adds and the bias add, as the graph counts them."""
    return mac_ops(layer, batch) + batch * layer["n"]


def nbytes(layer, batch: int) -> float:
    eb = 1 if layer["precision"] == "int8" else 4
    out_b = 1 if layer.get("out_int8") else 4
    m, k, n = batch, layer["k_in"], layer["n"]
    return m * k * eb + k * n * eb + 4 * (m + 2 * n) + m * n * out_b
