"""Symmetric per-column int8 quantization (the PTQ weight quantizer).

Replaces the Pallas kernel ``quantize_apply`` (src/repro/kernels/quantize.py,
``_kernel``) with ``csrc/quantize.cu``. The scales come from one plain
reduction that reads the matrix once (``column_scales``); the kernel
fuses scale broadcast, round, clip and cast in one pass, reading the fp32
matrix once and writing int8. It is bound by memory traffic (4 bytes in,
1 byte out per element, no reuse): each thread owns a group of columns
and walks down the rows, four columns (one 16-byte load, one 4-byte
store per row) when ``vector_width`` allows it, one otherwise.

Arithmetic: ``q = clip(rint(x * (1 / scale)), -127, 127)`` — the kernel
multiplies by the correctly rounded float32 reciprocal, as the Pallas
kernel does (a plain division can differ by one code).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def vector_width(x: torch.Tensor, q: torch.Tensor) -> int:
    """Columns a kernel thread owns: 4 when N % 4 == 0, ``x`` is 16-byte
    and ``q`` 4-byte aligned (one float4 load, one 32-bit store a row),
    else 1 (e.g. N = 1, or a view that starts inside a 16-byte word)."""
    if (x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0
            and q.data_ptr() % 4 == 0):
        return 4
    return 1


def quantize_apply_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / scale.float()
    q = torch.round(x.float() * inv[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_apply(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x`` [M, N] float32, ``scale`` [N] float32 -> int8 [M, N].
    Refuses a gradient on card operands (``build.refuse_grad``)."""
    build.refuse_grad("quantize_apply", x, scale)
    if x.ndim != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"quantize_apply: x {tuple(x.shape)} with scale "
                         f"{tuple(scale.shape)}")
    if build.on_cpu(x, scale):
        return quantize_apply_plain(x, scale)
    if x.shape[1] >= 2 ** 31:
        raise ValueError(f"quantize_apply: N = {x.shape[1]} past the "
                         f"kernel's 32-bit column index")
    global launches
    x = x.float().contiguous()
    scale = scale.float().contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = build.library("quantize_apply")
    fn = lib.quantize_apply
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(x), build.ptr(scale), build.ptr(q), x.shape[0],
            x.shape[1], int(vector_width(x, q) == 4), build.stream(x))
    build.check(lib, rc, "quantize_apply")
    launches += 1
    return q


def absmax_scale(xf: torch.Tensor, dim: Optional[int] = None
                 ) -> torch.Tensor:
    """max |x| / 127 + 1e-12 over ``dim`` (all of ``xf`` if None), in one
    reduction that reads ``xf`` once (no fp32 copy of |x|); a max of
    absolute values rounds nothing, so it equals ``amax(abs(x))``."""
    return torch.linalg.vector_norm(xf, ord=float("inf"), dim=dim
                                    ) / 127.0 + 1e-12


def quantize(x: torch.Tensor, axis: Optional[int] = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column (or per-tensor) int8. Returns (q, scale)."""
    xf = x.float()
    if axis is None:
        scale = absmax_scale(xf)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale
    if x.ndim != 2 or axis != 0:
        raise ValueError("kernel path: 2-D, per-column scales")
    scale = absmax_scale(xf, dim=0)
    return quantize_apply(xf, scale), scale
