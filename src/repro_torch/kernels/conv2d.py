"""NHWC int8 conv2d with the fused dequant epilogue (the DPU analog's conv
engine), plus the shared SAME/VALID pad geometry.

``conv2d_int8`` replaces the Pallas kernel ``conv2d_int8``
(src/repro/kernels/conv2d.py, ``_kernel_int8``) with
``csrc/conv2d_int8.cu``. The TPU kernel held a whole padded image in VMEM
and ran KH*KW shifted matmuls per output row. On Hopper the conv is an
implicit GEMM on the tensor cores (``mma.sync`` m16n8k32 int8, int32 sums,
so bit-exact in any order; ``csrc/igemm.cuh`` holds the skeleton): M is a
4 x 32 sub-tile of output pixels, N the block's channels, K the filter's
own [KH, KW, Cin] order padded to 32. Blocks are persistent, stage their
filter slice once and walk tiles of 1, 2 or 4 sub-tiles (``sub_tiles``
picks the count from the footprint and the tile count: a schedule, never
a result) with the next tiles' input patches in flight (cp.async, three
slots); the SAME padding is produced as zeros while staging, so no padded
copy of the input is written. Cin a multiple of 16 is read from the patch
in place; other Cin (the stem's 2) through im2col rows built in shared
memory. Each warp stages its outputs in shared memory and writes them as
16-byte stores. The served layers' byte bounds are far below the kernel's
times, which the epilogue and staging instruction rates set (PERF.md has
both). ``tests/test_torch_conv_igemm.py`` mirrors the kernels' index map
on the CPU.

Epilogue: ``fma(f32(acc), w_scale[co] * f32(x_scale), bias[co])`` — the
dequant product is formed first, and the bias add is one rounding, as the
reference's backend computes it — then act and the optional requantize.

``cout_per_block`` replaces the reference's second Pallas grid
(``conv2d.py``, the ``cout_per_block`` pallas_call), which the plan-time
autotuner selects: the CUDA grid gains a channel-block axis and each block
stages only its [KH, KW, Cin, bc] filter slice, which lifts the whole-Cout
shared-memory limit (a 3x3x128 -> 512 filter does not fit one block
whole). ``pre_padded``/``in_hw``/``rows_per_block``/``cout`` have the
reference's meaning (an input already staged by :func:`conv_geometry` at
``rows_per_block``, weights padded to whole channel blocks with the
logical ``cout`` passed apart); ``rows_per_block`` fixes only that staging
geometry, the CUDA sub-tile stays 4 x 32 pixels. Launches of the two grids are
counted apart (``launches``, ``launches_cout_blocks``). A whole-Cout call
whose filter slice does not fit one block (the VAE's 96 -> 144 and
144 -> 144 convs) runs the channel-blocked grid with the largest block of
8k channels that fits (:func:`fit_channel_block`): which channels a block
computes changes no output, and the launch counts under ``launches``, as
the whole-Cout call it serves.

``conv2d`` replaces the reference's fp32 Pallas kernel (``conv2d.py``,
``_kernel``) with ``csrc/conv2d_f32.cu``: NHWC SAME/VALID, stride s, bias
and optional relu, on the same skeleton with the product in 3xTF32
``mma.sync`` m16n8k8 (the split of ``csrc/flash_attention.cu``, within
1e-4 of fp32; bias add and relu in IEEE fp32). It lies on no served path,
as in the reference.

The kernels copy their input with 16-byte ``cp.async``: an input whose
address is not 16-byte aligned (a view into another tensor) is first
copied into a fresh buffer.

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

# launches of the CUDA kernels (the plain versions do not count): the
# whole-Cout int8 grid, the channel-blocked int8 grid, the fp32 conv
launches = 0
launches_cout_blocks = 0
launches_f32 = 0

_ACT_CODE = {None: 0, "relu": 1, "sigmoid": 2}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
_F32_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                 + [ctypes.c_void_p])
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block can use
MAX_GRID_Y = 65535          # channel blocks ride on gridDim.y
# a tile of more than one 4-row sub-tile only while three blocks still fit
# an SM's shared memory
SUB_TILE_SMEM = 72 * 1024


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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte-aligned address (the kernels' input
    copies are 16-byte ``cp.async``): a misaligned view is copied once."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _staging(x_q: torch.Tensor, kh: int, kw: int, stride: int,
             padding: str, rows_per_block: int, pre_padded: bool,
             in_hw) -> ConvGeom:
    """The geometry of a call, checking a pre-padded input against it."""
    if not pre_padded:
        return conv_geometry(int(x_q.shape[1]), int(x_q.shape[2]), kh, kw,
                             stride, padding, rows_per_block)
    if in_hw is None:
        raise ValueError("pre_padded=True needs in_hw=(H, W)")
    g = conv_geometry(int(in_hw[0]), int(in_hw[1]), kh, kw, stride, padding,
                      rows_per_block)
    if tuple(x_q.shape[1:3]) != (g.h_pad, g.w_pad):
        raise ValueError(
            f"pre-padded input {tuple(x_q.shape)} does not match geometry "
            f"({g.h_pad}, {g.w_pad})")
    return g


def conv2d_int8_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      x_scale: float = 1.0, stride: int = 1,
                      padding: str = "SAME", act: Optional[str] = None,
                      requant_scale: Optional[float] = None,
                      rows_per_block: int = 8, cout: Optional[int] = None,
                      pre_padded: bool = False,
                      in_hw=None) -> torch.Tensor:
    """The same function in plain PyTorch: shift-and-matmul over the taps,
    with the int32 sums formed exactly in float64. Channel blocks are
    independent, so the result does not depend on ``cout_per_block``;
    padded weight channels past ``cout`` are sliced off."""
    b = x_q.shape[0]
    kh, kw, _, cw = w_q.shape
    cout = cw if cout is None else int(cout)
    g = _staging(x_q, kh, kw, stride, padding, rows_per_block, pre_padded,
                 in_hw)
    xp = (x_q if pre_padded else pad_input(x_q, g)).double()
    w = w_q[..., :cout].double()
    acc = torch.zeros((b, g.h_out, g.w_out, cout), dtype=torch.float64,
                      device=x_q.device)
    for r in range(kh):
        for c in range(kw):
            taps = xp[:, r:r + (g.h_out - 1) * stride + 1:stride,
                      c:c + (g.w_out - 1) * stride + 1:stride, :]
            acc += taps @ w[r, c]
    dequant = w_scale[:cout].float() * f32(x_scale)
    out = dequant_bias(acc, dequant, None if bias is None else bias[:cout])
    return apply_epilogue(out, act, requant_scale)


@functools.lru_cache(maxsize=None)
def smem_bytes(cin: int, bc: int, kh: int, kw: int, stride: int,
               requant: bool = True, msub: int = 1) -> int:
    """Dynamic shared memory one block of the int8 kernel takes for ``bc``
    output channels (filter slice, the input-patch ring for tiles of
    ``msub`` 4-row sub-tiles, the im2col rows for small Cin and the output
    staging, int8 with ``requant`` else f32; ``bc`` = Cout for the
    whole-Cout grid), as the kernel's own code sizes it (builds the kernel
    library on first use)."""
    lib = build.library("conv2d_int8")
    fn = lib.conv2d_int8_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_int
    return fn(cin, bc, kh, kw, stride, int(requant), msub)


def fit_channel_block(cout: int, smem_of) -> int:
    """The largest channel block, a multiple of 8 below ``cout``, whose
    block (``smem_of(bc)`` bytes of shared memory) fits a Hopper block; 0
    when not even 8 channels fit."""
    for bc in range((cout - 1) // 8 * 8, 0, -8):
        if smem_of(bc) <= _SMEM_LIMIT:
            return bc
    return 0


def sub_tiles(b: int, h_out: int, w_out: int, sms: int, smem_of) -> int:
    """4-row sub-tiles per tile of the conv kernels (4, 2 or 1): the most
    whose block (``smem_of(msub)`` bytes) still fits three to an SM while
    the launch keeps at least four tiles per SM. Each sub-tile more spreads
    a tile's fixed work (the patch ring, the block barrier, the tile's
    setup) over 128 more pixels and re-reads fewer input rows; the pick
    changes the schedule only, never a result."""
    for msub in (4, 2):
        tiles = b * -(-h_out // (4 * msub)) * -(-w_out // 32)
        if smem_of(msub) <= SUB_TILE_SMEM and tiles >= 4 * sms:
            return msub
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                x_scale: float = 1.0, stride: int = 1, padding: str = "SAME",
                relu: bool = False, act: Optional[str] = None,
                requant_scale: Optional[float] = None,
                rows_per_block: int = 8, cout_per_block: int = 0,
                cout: Optional[int] = None, pre_padded: bool = False,
                in_hw=None) -> torch.Tensor:
    """Quantized conv ``deq(conv_int32(x_q, w_q))`` with fused epilogue.
    ``x_q`` [B, H, W, Cin] int8, ``w_q`` [KH, KW, Cin, Cout(_pad)] int8
    (HWIO), ``w_scale``/``bias`` [Cout(_pad)] f32, ``x_scale`` the static
    per-tensor input scale. Returns [B, H_out, W_out, cout] f32, or int8
    with ``requant_scale``.

    ``cout_per_block`` > 0 runs the channel-blocked grid whenever it
    leaves more than one block (as the reference picks its grid);
    ``cout`` is the logical channel count of padded weights;
    ``pre_padded`` says ``x_q`` was staged by :func:`pad_input` at
    ``rows_per_block`` from the logical ``in_hw``. Without
    ``cout_per_block``, a filter slice too large for one block takes the
    channel-blocked grid with the largest block that fits, counted as
    ``launches`` (a whole-Cout call). Refuses a gradient on card operands
    (``build.refuse_grad``)."""
    build.refuse_grad("conv2d_int8", x_q, w_q, w_scale, bias)
    act = normalize_act(relu, act)
    cw = w_q.shape[3] if w_q.ndim == 4 else 0
    if (x_q.ndim != 4 or w_q.ndim != 4 or x_q.shape[3] != w_q.shape[2]
            or x_q.dtype != torch.int8 or w_q.dtype != torch.int8
            or w_scale.shape != (cw,)
            or (bias is not None and bias.shape != (cw,))
            or cout_per_block < 0 or rows_per_block <= 0
            or (cout is not None and not 0 < cout <= cw)):
        raise ValueError(
            f"conv2d_int8: x {tuple(x_q.shape)} {x_q.dtype}, w "
            f"{tuple(w_q.shape)} {w_q.dtype}, w_scale "
            f"{tuple(w_scale.shape)}, cout {cout}, cout_per_block "
            f"{cout_per_block}, rows_per_block {rows_per_block}")
    kh, kw = int(w_q.shape[0]), int(w_q.shape[1])
    g = _staging(x_q, kh, kw, stride, padding, rows_per_block, pre_padded,
                 in_hw)
    if build.on_cpu(x_q, w_q, w_scale, bias):
        return conv2d_int8_plain(x_q, w_q, w_scale, bias, x_scale=x_scale,
                                 stride=stride, padding=padding, act=act,
                                 requant_scale=requant_scale,
                                 rows_per_block=rows_per_block, cout=cout,
                                 pre_padded=pre_padded, in_hw=in_hw)
    global launches, launches_cout_blocks
    b, h, wd, cin = (int(d) for d in x_q.shape)
    cout = cw if cout is None else int(cout)
    # the reference's grid choice: channel blocks of bc over cout_pad
    # (the weight's channels rounded up to whole blocks), unless one
    # block would hold them all
    bc = cout_per_block or cw
    blocks = -(-cw // bc) * bc != bc
    requant = requant_scale is not None
    bcw = bc if blocks else cout
    smem = smem_bytes(cin, bcw, kh, kw, stride, requant)
    fitted = smem > _SMEM_LIMIT and not blocks
    if fitted:
        # the whole-Cout slice does not fit: the same kernel's
        # channel-blocked grid, with the largest block that does
        bc = fit_channel_block(cout, lambda c: smem_bytes(
            cin, c, kh, kw, stride, requant))
        if bc:
            blocks, bcw = True, bc
            smem = smem_bytes(cin, bc, kh, kw, stride, requant)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"conv2d_int8: a {kh}x{kw}x{cin}x{bc if blocks else cout} "
            f"filter slice needs {smem} B of shared memory per block "
            f"(at most {_SMEM_LIMIT}); set a smaller cout_per_block")
    if blocks and -(-cout // bc) > MAX_GRID_Y:
        raise ValueError(f"conv2d_int8: {-(-cout // bc)} channel blocks "
                         f"exceed gridDim.y ({MAX_GRID_Y})")
    x_q, w_q = _aligned(x_q), w_q.contiguous()
    w_scale = w_scale.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    out = torch.empty((b, g.h_out, g.w_out, cout), device=x_q.device,
                      dtype=torch.int8 if requant else torch.float32)
    # a pre-padded input is read as stored: its dims, pad offsets 0
    pad_top, pad_left = (0, 0) if pre_padded else (g.pad_top, g.pad_left)
    lib = build.library("conv2d_int8")
    fn = lib.conv2d_int8
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    msub = sub_tiles(b, g.h_out, g.w_out, _sm_count(x_q.device.index),
                     lambda m: smem_bytes(cin, bcw, kh, kw, stride, requant,
                                          m))
    rc = fn(build.ptr(x_q), build.ptr(w_q), build.ptr(w_scale),
            build.ptr(bias), build.ptr(out), b, h, wd, cin, cout, cw, kh, kw,
            stride, pad_top, pad_left, g.h_out, g.w_out,
            bc if blocks else 0, msub, f32(x_scale), _ACT_CODE[act],
            int(requant),
            reciprocal_f32(requant_scale) if requant else 0.0,
            build.stream(x_q))
    build.check(lib, rc, "conv2d_int8")
    if blocks and not fitted:
        launches_cout_blocks += 1
    else:
        launches += 1
    return out


# ---------------------------------------------------------------------------
# fp32 conv2d
# ---------------------------------------------------------------------------


def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                 padding: str = "SAME", relu: bool = False) -> torch.Tensor:
    """The fp32 conv in plain PyTorch, shift-and-matmul over the taps as
    the reference's kernel computes it (float32 sums)."""
    b = x.shape[0]
    kh, kw, _, cout = w.shape
    g = conv_geometry(int(x.shape[1]), int(x.shape[2]), kh, kw, stride,
                      padding)
    xp = pad_input(x.float(), g)
    acc = torch.zeros((b, g.h_out, g.w_out, cout), dtype=torch.float32,
                      device=x.device)
    for r in range(kh):
        for c in range(kw):
            taps = xp[:, r:r + (g.h_out - 1) * stride + 1:stride,
                      c:c + (g.w_out - 1) * stride + 1:stride, :]
            acc = acc + taps @ w[r, c].float()
    if bias is not None:
        acc = acc + bias.float()
    return torch.clamp_min(acc, 0.0) if relu else acc


@functools.lru_cache(maxsize=None)
def f32_block_channels(cin: int, cout: int, kh: int, kw: int,
                       stride: int) -> int:
    """Output channels per block of the fp32 kernel: a multiple of 8 up to
    64, halved until the block's shared memory (patch ring, filter slice,
    im2col rows, output staging) fits (0 when not even 8 channels fit)."""
    lib = build.library("conv2d_f32")
    fn = lib.conv2d_f32_block_channels
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(cin, cout, kh, kw, stride)


@functools.lru_cache(maxsize=None)
def f32_smem_bytes(cin: int, bc: int, kh: int, kw: int, stride: int,
                   msub: int = 1) -> int:
    """Dynamic shared memory one block of the fp32 kernel takes."""
    lib = build.library("conv2d_f32")
    fn = lib.conv2d_f32_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
    return fn(cin, bc, kh, kw, stride, msub)


def conv2d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, stride: int = 1,
           padding: str = "SAME", relu: bool = False) -> torch.Tensor:
    """fp32 NHWC conv + bias + optional relu: ``x`` [B, H, W, Cin], ``w``
    [KH, KW, Cin, Cout] (HWIO), ``bias`` [Cout]. Returns [B, H_out, W_out,
    Cout] float32. Refuses a gradient on card operands
    (``build.refuse_grad``)."""
    build.refuse_grad("conv2d", x, w, bias)
    if (x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]
            or (bias is not None and bias.shape != (w.shape[3],))):
        raise ValueError(f"conv2d: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if build.on_cpu(x, w, bias):
        return conv2d_plain(x, w, bias, stride=stride, padding=padding,
                            relu=relu)
    global launches_f32
    b, h, wd, cin = (int(d) for d in x.shape)
    kh, kw, _, cout = (int(d) for d in w.shape)
    g = conv_geometry(h, wd, kh, kw, stride, padding)
    bc = f32_block_channels(cin, cout, kh, kw, stride)
    if bc == 0:
        raise ValueError(f"conv2d: a {kh}x{kw}x{cin} filter's input patch "
                         f"does not fit one block's shared memory")
    if -(-cout // bc) > MAX_GRID_Y:
        raise ValueError(f"conv2d: {-(-cout // bc)} channel blocks exceed "
                         f"gridDim.y ({MAX_GRID_Y})")
    x, w = _aligned(x.float()), w.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    out = torch.empty((b, g.h_out, g.w_out, cout), device=x.device,
                      dtype=torch.float32)
    lib = build.library("conv2d_f32")
    fn = lib.conv2d_f32
    fn.argtypes, fn.restype = _F32_ARGTYPES, ctypes.c_int
    msub = sub_tiles(b, g.h_out, g.w_out, _sm_count(x.device.index),
                     lambda m: f32_smem_bytes(cin, bc, kh, kw, stride, m))
    rc = fn(build.ptr(x), build.ptr(w), build.ptr(bias), build.ptr(out), b,
            h, wd, cin, cout, kh, kw, stride, g.pad_top, g.pad_left, g.h_out,
            g.w_out, bc, msub, int(relu), build.stream(x))
    build.check(lib, rc, "conv2d")
    launches_f32 += 1
    return out
