"""Kernels layer (``kernels/int8_matmul.py``, split-K at M <= 16): the
int8 dense layers' share of their roofline (``bench/roofline.py``)."""
from bench.roofline import share


def read(run):
    return share(run, "dense", "int8")
