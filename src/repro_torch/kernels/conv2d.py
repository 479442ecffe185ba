"""NHWC int8 conv2d with the fused dequant epilogue (the DPU analog's conv
engine), plus the shared SAME/VALID pad geometry.

``conv2d_int8`` replaces the Pallas kernel ``conv2d_int8``
(src/repro/kernels/conv2d.py, ``_kernel_int8``) with
``csrc/conv2d_int8.cu``. The TPU kernel held a whole padded image in VMEM
and ran KH*KW shifted matmuls per output row. On Hopper a block owns an
8 x 32 tile of output pixels for all output channels and stages the input
patch and the filter in shared memory, so each input byte is read from
device memory about once; the SAME padding is produced while staging
(zero bytes), so no padded copy of the input is written. The served
layers are bound by memory traffic at the card's int8 rate; this simple
design is limited by its scalar ``__dp4a`` issue rate instead (its time is
in PERF.md beside the bound).

Epilogue: ``fma(f32(acc), w_scale[co] * f32(x_scale), bias[co])`` — the
dequant product is formed first, and the bias add is one rounding, as the
reference's backend computes it — then act and the optional requantize.

``ConvGeom``/``conv_geometry``/``pad_input`` are a plain copy of the
reference's geometry (pure functions of static shapes).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (apply_epilogue, dequant_bias, f32,
                                          normalize_act, reciprocal_f32)

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_ACT_CODE = {None: 0, "relu": 1, "sigmoid": 2}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block can use


class ConvGeom(NamedTuple):
    """Plan-time conv pad geometry, derived purely from static shapes."""
    h_out: int
    w_out: int
    rows: int                       # output rows per grid step
    n_row_blocks: int
    pad_top: int
    pad_bottom: int                 # includes row-block coverage padding
    pad_left: int
    pad_right: int
    h_pad: int                      # padded input dims
    w_pad: int


@functools.lru_cache(maxsize=None)
def conv_geometry(h: int, wd: int, kh: int, kw: int, stride: int,
                  padding: str, rows_per_block: int = 1) -> ConvGeom:
    """SAME/VALID geometry: the image is extended so every row window a
    grid of ``rows_per_block``-row blocks touches is in range. SAME pads
    are asymmetric when the total pad is odd (the extra row/column goes
    at the bottom/right). Pure function of static shapes, memoized."""
    if padding == "SAME":
        h_out = -(-h // stride)
        w_out = -(-wd // stride)
        pad_h = max((h_out - 1) * stride + kh - h, 0)
        pad_w = max((w_out - 1) * stride + kw - wd, 0)
        top, left = pad_h // 2, pad_w // 2
        bottom, right = pad_h - top, pad_w - left
    elif padding == "VALID":
        h_out = (h - kh) // stride + 1
        w_out = (wd - kw) // stride + 1
        top = bottom = left = right = 0
    else:
        raise ValueError(padding)
    rows = min(rows_per_block, h_out)
    n_row_blocks = -(-h_out // rows)
    need_h = (n_row_blocks * rows - 1) * stride + kh
    need_w = (w_out - 1) * stride + kw
    bottom += max(need_h - (h + top + bottom), 0)
    right += max(need_w - (wd + left + right), 0)
    return ConvGeom(h_out, w_out, rows, n_row_blocks, top, bottom, left,
                    right, h + top + bottom, wd + left + right)


def pad_input(x: torch.Tensor, g: ConvGeom) -> torch.Tensor:
    """Apply a :class:`ConvGeom` to one [B, H, W, C] batch."""
    if (g.pad_top, g.pad_bottom, g.pad_left, g.pad_right) == (0, 0, 0, 0):
        return x
    return F.pad(x, (0, 0, g.pad_left, g.pad_right, g.pad_top, g.pad_bottom))


def conv2d_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      x_scale: float = 1.0, stride: int = 1,
                      padding: str = "SAME", act: Optional[str] = None,
                      requant_scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: shift-and-matmul over the taps,
    with the int32 sums formed exactly in float64."""
    b, h, wd, cin = x_q.shape
    kh, kw, _, cout = w_q.shape
    g = conv_geometry(h, wd, kh, kw, stride, padding)
    xp = pad_input(x_q, g).double()
    w = w_q.double()
    acc = torch.zeros((b, g.h_out, g.w_out, cout), dtype=torch.float64,
                      device=x_q.device)
    for r in range(kh):
        for c in range(kw):
            taps = xp[:, r:r + (g.h_out - 1) * stride + 1:stride,
                      c:c + (g.w_out - 1) * stride + 1:stride, :]
            acc += taps @ w[r, c]
    dequant = w_scale.float() * f32(x_scale)
    out = dequant_bias(acc, dequant, bias)
    return apply_epilogue(out, act, requant_scale)


def smem_bytes(cin: int, cout: int, kh: int, kw: int, stride: int) -> int:
    """Dynamic shared memory one block of the CUDA kernel takes for this
    filter (input patch + filter tile), as the kernel's own code sizes
    it (builds the kernel library on first use)."""
    lib = build.library("conv2d_int8")
    fn = lib.conv2d_int8_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(cin, cout, kh, kw, stride)


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                x_scale: float = 1.0, stride: int = 1, padding: str = "SAME",
                relu: bool = False, act: Optional[str] = None,
                requant_scale: Optional[float] = None) -> torch.Tensor:
    """Quantized conv ``deq(conv_int32(x_q, w_q))`` with fused epilogue.
    ``x_q`` [B, H, W, Cin] int8, ``w_q`` [KH, KW, Cin, Cout] int8 (HWIO),
    ``w_scale``/``bias`` [Cout] f32, ``x_scale`` the static per-tensor
    input scale. Returns [B, H_out, W_out, Cout] f32, or int8 with
    ``requant_scale``."""
    act = normalize_act(relu, act)
    if (x_q.ndim != 4 or w_q.ndim != 4 or x_q.shape[3] != w_q.shape[2]
            or x_q.dtype != torch.int8 or w_q.dtype != torch.int8
            or w_scale.shape != (w_q.shape[3],)
            or (bias is not None and bias.shape != (w_q.shape[3],))):
        raise ValueError(
            f"conv2d_int8: x {tuple(x_q.shape)} {x_q.dtype}, w "
            f"{tuple(w_q.shape)} {w_q.dtype}, w_scale "
            f"{tuple(w_scale.shape)}")
    if build.on_cpu(x_q, w_q, w_scale, bias):
        return conv2d_int8_plain(x_q, w_q, w_scale, bias, x_scale=x_scale,
                                 stride=stride, padding=padding, act=act,
                                 requant_scale=requant_scale)
    global launches
    b, h, wd, cin = x_q.shape
    kh, kw, _, cout = w_q.shape
    g = conv_geometry(h, wd, kh, kw, stride, padding)
    smem = smem_bytes(cin, cout, kh, kw, stride)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"conv2d_int8: a {kh}x{kw}x{cin}x{cout} filter "
                         f"needs {smem} B of shared memory per block")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    w_scale = w_scale.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    requant = requant_scale is not None
    out = torch.empty((b, g.h_out, g.w_out, cout), device=x_q.device,
                      dtype=torch.int8 if requant else torch.float32)
    lib = build.library("conv2d_int8")
    fn = lib.conv2d_int8
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(x_q), build.ptr(w_q), build.ptr(w_scale),
            build.ptr(bias), build.ptr(out), b, h, wd, cin, cout, kh, kw,
            stride, g.pad_top, g.pad_left, g.h_out, g.w_out, f32(x_scale),
            _ACT_CODE[act], int(requant),
            reciprocal_f32(requant_scale) if requant else 0.0,
            build.stream(x_q))
    build.check(lib, rc, "conv2d_int8")
    launches += 1
    return out
