"""A 2-D convolution layer: ``h x w x cin`` in, ``k x k`` SAME taps at
``stride``, ``cout`` out. The arithmetic and byte count of
``chip_smoke.py``'s conv phases: each input element read once at its
width (1 byte for int8 codes), the weights once, 8 bytes of scale and
bias per output channel, each output written once (1 byte when it leaves
as int8 codes, else 4)."""
from __future__ import annotations


def _out(layer):
    s = layer["stride"]
    return -(-layer["h"] // s), -(-layer["w"] // s)


def mac_ops(layer, batch: int) -> float:
    ho, wo = _out(layer)
    return 2.0 * batch * ho * wo * layer["cout"] * layer["k"] ** 2 \
        * layer["cin"]


def ops(layer, batch: int) -> float:
    """Multiply-adds and the bias add, as the graph counts them."""
    ho, wo = _out(layer)
    return mac_ops(layer, batch) + batch * ho * wo * layer["cout"]


def nbytes(layer, batch: int) -> float:
    eb = 1 if layer["precision"] == "int8" else 4
    ho, wo = _out(layer)
    out_b = 1 if layer.get("out_int8") else 4
    return (batch * layer["h"] * layer["w"] * layer["cin"] * eb
            + layer["k"] ** 2 * layer["cin"] * layer["cout"] * eb
            + 8 * layer["cout"] + batch * ho * wo * layer["cout"] * out_b)
