"""A 3-D convolution layer: ``d x h x w x cin`` in, ``k x k x k`` SAME
taps at ``stride``, ``cout`` out. Counted as ``conv2d.py`` counts a 2-D
convolution, at the widths of the layer's precision: on the fp32 flex
path each input element read once and each output written once at 4
bytes, the weights once at 4 bytes, 4 bytes of bias per output channel;
an int8 layer reads 1-byte codes and 8 bytes of scale and bias per output
channel, and writes 1 byte where its output leaves as int8 codes."""
from __future__ import annotations


def _out(layer):
    s = layer["stride"]
    return -(-layer["d"] // s), -(-layer["h"] // s), -(-layer["w"] // s)


def mac_ops(layer, batch: int) -> float:
    do, ho, wo = _out(layer)
    return 2.0 * batch * do * ho * wo * layer["cout"] * layer["k"] ** 3 \
        * layer["cin"]


def ops(layer, batch: int) -> float:
    """Multiply-adds and the bias add, as the graph counts them."""
    do, ho, wo = _out(layer)
    return mac_ops(layer, batch) + batch * do * ho * wo * layer["cout"]


def nbytes(layer, batch: int) -> float:
    int8 = layer["precision"] == "int8"
    eb = 1 if int8 else 4
    out_b = 1 if layer.get("out_int8") else 4
    do, ho, wo = _out(layer)
    return (batch * layer["d"] * layer["h"] * layer["w"] * layer["cin"] * eb
            + layer["k"] ** 3 * layer["cin"] * layer["cout"] * eb
            + (8 if int8 else 4) * layer["cout"]
            + batch * do * ho * wo * layer["cout"] * out_b)
