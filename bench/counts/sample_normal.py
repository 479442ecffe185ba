"""The reparameterised sample ``mu + exp(logvar / 2) eps`` of ``size``
elements: three operations an element, as the graph counts it; ``mu`` and
``logvar`` read, the sample written, a key pair per row."""
from __future__ import annotations


def mac_ops(layer, batch: int) -> float:
    return 0.0


def ops(layer, batch: int) -> float:
    return 3.0 * batch * layer["size"]


def nbytes(layer, batch: int) -> float:
    return 12.0 * batch * layer["size"] + 8.0 * batch
