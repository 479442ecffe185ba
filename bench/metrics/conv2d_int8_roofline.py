"""Kernels layer (``kernels/conv2d.py``, ``csrc/conv2d_int8.cu``): the
int8 convolutions' share of their roofline (``bench/roofline.py``)."""
from bench.roofline import share


def read(run):
    return share(run, "conv2d", "int8")
