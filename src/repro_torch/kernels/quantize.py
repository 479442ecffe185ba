"""Symmetric per-column int8 quantization (the PTQ weight quantizer).

Replaces the Pallas kernel ``quantize_apply`` (src/repro/kernels/quantize.py,
``_kernel``) with ``csrc/quantize.cu``. The scales come from a plain
reduction (``quantize``); the kernel fuses scale broadcast, round, clip
and cast in one pass, reading the fp32 matrix once and writing int8. It
is bound by memory traffic (4 bytes in, 1 byte out per element, no
reuse): one thread per element, neighbouring threads on neighbouring
addresses, so loads and stores coalesce.

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
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def quantize_apply_plain(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    inv = 1.0 / scale.float()
    q = torch.round(x.float() * inv[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_apply(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x`` [M, N] float32, ``scale`` [N] float32 -> int8 [M, N]."""
    if x.ndim != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"quantize_apply: x {tuple(x.shape)} with scale "
                         f"{tuple(scale.shape)}")
    if build.on_cpu(x, scale):
        return quantize_apply_plain(x, scale)
    global launches
    x = x.float().contiguous()
    scale = scale.float().contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = build.library("quantize_apply")
    fn = lib.quantize_apply
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(x), build.ptr(scale), build.ptr(q), x.shape[0],
            x.shape[1], build.stream(x))
    build.check(lib, rc, "quantize_apply")
    launches += 1
    return q


def quantize(x: torch.Tensor, axis: Optional[int] = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column (or per-tensor) int8. Returns (q, scale)."""
    xf = x.float()
    if axis is None:
        scale = torch.amax(torch.abs(xf)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return q, scale
    if x.ndim != 2 or axis != 0:
        raise ValueError("kernel path: 2-D, per-column scales")
    scale = torch.amax(torch.abs(xf), dim=0) / 127.0 + 1e-12
    return quantize_apply(xf, scale), scale
