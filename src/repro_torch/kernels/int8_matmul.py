"""INT8 x INT8 -> INT32 matmul with the fused dequant epilogue (the DPU
analog's dense engine).

Replaces the Pallas kernel ``int8_matmul`` (src/repro/kernels/int8_matmul.py,
``_kernel``) with two hand-written CUDA kernels that compute the same
function, and :func:`route` chooses between them by shape:

* **split-K** (``csrc/int8_matmul.cu``), for a small batch M against a long
  K (CNet's fc1: [16, 32769] x [32769, 92]), where the product is bound by
  reading the weights once: each block streams its slice of
  ``SPLITK_K_ROWS`` weight rows into shared memory with 16-byte copies
  (all in flight at once), its warps split that K, and the block's int32
  sums are added atomically (exact, order-free) into a persistent scratch;
  the last block of each output tile applies the epilogue and zeroes the
  sums it consumed, so the scratch is zeroed once, when it is allocated,
  and no call launches a memset. A K of at most ``SPLITK_K_ROWS`` is one
  block per tile and needs no scratch. M / 16 row tiles ride on
  ``gridDim.z``, so M is capped at ``ROWS_PER_BLOCK * MAX_GRID_Z``.
* **tile** (``csrc/int8_matmul_tile.cu``), for the LM's per-position
  projections, which fold batch x positions into M (8192 at a B=4
  prefill) and are bound by the int8 tensor-core rate: one block of two
  warpgroups per 128 x 128 output tile runs ``wgmma`` m64n128k32 with the
  int32 sums in registers (no atomics, no scratch; for N <= 64 one
  warpgroup per 64 x 64 tile). Each weight tile is copied as it lies and
  transposed to K-major in shared memory, so the plan's one live copy of
  each weight is read in place. Output tiles lie on ``gridDim.x`` (at most
  2^31 - 1).

The rule (:func:`route`), set from both kernels' device times at small M
(``chip_smoke.py``'s route phase): K below one 32-deep ``wgmma`` step
takes split-K; above that, M over ``SPLITK_MAX_M`` (32: CNet's batches and
the LM's decode lanes are at most that) takes the tile kernel. At M <= 32
the tile kernel runs one row tile, and its time grows with K (each block
walks all of K) while split-K's spreads K over blocks, so the tile kernel
takes K up to ``SMALL_M_TILE_MAX_K`` (2048: the LM's decode projections
but down_proj) with N at least one 64-column tile; CNet's fc1 (K = 32769)
and one-column head keep split-K. Row strides and bases that are not
16-byte aligned do not change the route: the tile kernel then stages
through byte loads instead of vector loads. Either kernel indexes [M, N]
in 64-bit.

Prepacked weights (``prepacked=True``, the autotuner's arena) arrive as
[kp, np] zero-padded to whole (bk, bn) tiles with ``w_scale``/``bias`` at
length np; both kernels read them in place with row stride np, loop over
x's logical K and write only ``n_out`` columns, so the result equals the
unpacked product bit for bit.

Epilogue: ``fma((f32(acc) * x_scale[m]), w_scale[n], bias[n])`` (one
rounding for the bias add, as the reference's backend computes it), then
relu/sigmoid, then the optional requantize ``clip(rint(x * (1/s)))``.

Counters: ``launches`` counts every CUDA launch; ``launches_tile`` and
``launches_splitk`` count each kernel's share of them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (apply_epilogue, dequant_bias,
                                          normalize_act, out_dtype_for,
                                          reciprocal_f32)

# launches of the CUDA kernels (the plain version does not count), in all
# and by route
launches = 0
launches_tile = 0
launches_splitk = 0

ROWS_PER_BLOCK = 16             # the split-K kernel's row tile (kMT)
SPLITK_K_ROWS = 256             # its K rows per block (kKB)
SPLITK_COLS = 128               # its columns per block (kBN)
SPLITK_WARPS = 8                # its warps, which split a block's K
MAX_GRID_Z = 65535              # CUDA's gridDim.z cap: row tiles per launch
TILE_M = TILE_N = 128           # the tile kernel's output tile (N > 64)
MAX_GRID_X = 2 ** 31 - 1        # CUDA's gridDim.x cap: tiles per launch
TILE_MIN_K = 32                 # one wgmma K step: less takes split-K
SPLITK_MAX_M = 32               # larger M takes the tile kernel, and so
SMALL_M_TILE_MAX_K = 2048       # does smaller M with K at most this
SMALL_M_TILE_MIN_N = 64         # and N at least this

_ACT_CODE = {None: 0, "relu": 1, "sigmoid": 2}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
_TILE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                  + [ctypes.c_float, ctypes.c_void_p])


def route(m: int, k: int, n: int) -> str:
    """The kernel that serves an [m, k] x [k, n] product: ``"tile"``
    (tensor cores) when k >= ``TILE_MIN_K`` and either m >
    ``SPLITK_MAX_M``, or k <= ``SMALL_M_TILE_MAX_K`` and n >=
    ``SMALL_M_TILE_MIN_N``; else ``"splitk"``. The weights' row stride
    does not decide it: the tile kernel takes any stride (byte loads where
    one is not aligned)."""
    small_m_tile = k <= SMALL_M_TILE_MAX_K and n >= SMALL_M_TILE_MIN_N
    return ("tile" if k >= TILE_MIN_K and (m > SPLITK_MAX_M or small_m_tile)
            else "splitk")


def splitk_grid(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The split-K kernel's grid: (K blocks, column tiles, row tiles)."""
    return (max(1, -(-k // SPLITK_K_ROWS)), -(-n // SPLITK_COLS),
            -(-m // ROWS_PER_BLOCK))


def splitk_scratch_words(m: int, k: int, n: int) -> int:
    """int32 words of zeroed scratch a split-K launch needs: the [M, N]
    sums and one ticket per output tile, or none when one block covers
    K."""
    kc, nt, mt = splitk_grid(m, k, n)
    return 0 if kc == 1 else m * n + nt * mt


# the split-K kernel's scratch on each device: zero between calls (the
# kernel's last blocks write back the zeros), replaced by a larger zeroed
# buffer when a launch needs more
_SPLITK_SCRATCH: Dict[torch.device, torch.Tensor] = {}


def _splitk_scratch(device: torch.device, words: int
                    ) -> Optional[torch.Tensor]:
    if words == 0:
        return None
    buf = _SPLITK_SCRATCH.get(device)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        _SPLITK_SCRATCH[device] = buf
    return buf


def _aligned_block(dim: int, target: int) -> int:
    """Full ``target`` tiles when the dim is big enough, otherwise the dim
    rounded up to a multiple of 8."""
    if dim >= target:
        return target
    return -(-dim // 8) * 8


def heuristic_blocks(m: int, k: int, n: int,
                     bm: int = 128, bn: int = 128, bk: int = 128):
    """The reference's default block choice for an [M, K] x [K, N] matmul,
    kept for the autotuner's candidate pools (the CUDA kernels' own tiles
    are fixed: split-K 16 rows x 128 columns x 256-deep K slices, tile
    128 x 128 x 128-deep K stages)."""
    return (min(bm, _aligned_block(m, bm)),
            min(bn, _aligned_block(n, bn)),
            min(bk, _aligned_block(k, bk)))


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None,
                      requant_scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: the int32 sums are formed
    exactly in float64 (|acc| <= 127^2 * K stays far below 2^53)."""
    acc = x_q.double() @ w_q.double()
    out = dequant_bias(acc, w_scale[None, :],
                       None if bias is None else bias[None, :],
                       pre=x_scale[:, None])
    return apply_epilogue(out, act, requant_scale)


def _unpack(x_q, w_q, w_scale, bias, bm, bn, bk, n_out):
    """Check a prepacked operand set against its (bk, bn) layout and
    return the logical N: w_q [kp, np] with kp, np whole tiles, x_q's K at
    most kp, ``n_out`` at most np."""
    k = x_q.shape[1]
    kp, np_ = w_q.shape
    n = np_ if n_out is None else int(n_out)
    if (bm <= 0 or bn <= 0 or bk <= 0 or kp % bk or np_ % bn or k > kp
            or not 0 < n <= np_ or w_scale.shape != (np_,)
            or (bias is not None and bias.shape != (np_,))):
        raise ValueError(
            f"int8_matmul: prepacked w {tuple(w_q.shape)} does not hold "
            f"(bk={bk}, bn={bn}) tiles for x {tuple(x_q.shape)}, n_out "
            f"{n_out}, w_scale {tuple(w_scale.shape)}")
    return n


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                x_scale: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                bm: int = 128, bn: int = 128, bk: int = 128,
                relu: bool = False, act: Optional[str] = None,
                requant_scale: Optional[float] = None,
                out_dtype: torch.dtype = torch.float32,
                prepacked: bool = False,
                n_out: Optional[int] = None) -> torch.Tensor:
    """``x_q`` [M, K] int8, ``w_q`` [K, N] int8, ``x_scale`` [M] f32
    (per row), ``w_scale`` [N] f32 and ``bias`` [N] f32 (per output
    column). Returns [M, N] ``out_dtype``, or int8 with ``requant_scale``.

    With ``prepacked`` the weights are the arena's tile-aligned [kp, np]
    buffer (scales and bias at length np) and the result is [M, n_out].
    ``bm``/``bn``/``bk`` are the reference's block sizes: ``bn``/``bk``
    fix the packed layout that is checked here, and none of them changes
    the CUDA kernels' own tiles: :func:`route` picks the kernel by shape.
    Refuses a gradient on card operands (``build.refuse_grad``)."""
    build.refuse_grad("int8_matmul", x_q, w_q, x_scale, w_scale, bias)
    act = normalize_act(relu, act)
    out_dtype = out_dtype_for(requant_scale, out_dtype)
    m, k = x_q.shape
    k2, n = w_q.shape
    if (x_q.dtype != torch.int8 or w_q.dtype != torch.int8
            or x_scale.shape != (m,)):
        raise ValueError(
            f"int8_matmul: x {tuple(x_q.shape)} {x_q.dtype}, w "
            f"{tuple(w_q.shape)} {w_q.dtype}, x_scale "
            f"{tuple(x_scale.shape)}")
    if prepacked:
        n = _unpack(x_q, w_q, w_scale, bias, bm, bn, bk, n_out)
    elif (k != k2 or w_scale.shape != (n,)
            or (bias is not None and bias.shape != (n,))):
        raise ValueError(
            f"int8_matmul: x {tuple(x_q.shape)}, w {tuple(w_q.shape)}, "
            f"w_scale {tuple(w_scale.shape)}")
    if build.on_cpu(x_q, w_q, x_scale, w_scale, bias):
        if prepacked:
            w_q, w_scale = w_q[:k, :n], w_scale[:n]
            bias = None if bias is None else bias[:n]
        out = int8_matmul_plain(x_q, w_q, x_scale, w_scale, bias, act,
                                requant_scale)
        return out.to(out_dtype)
    global launches, launches_tile, launches_splitk
    ldw = w_q.shape[1]
    which = route(m, k, n)
    if which == "splitk" and -(-m // ROWS_PER_BLOCK) > MAX_GRID_Z:
        raise ValueError(
            f"int8_matmul: M={m} needs {-(-m // ROWS_PER_BLOCK)} row tiles "
            f"of {ROWS_PER_BLOCK}; one launch takes at most {MAX_GRID_Z} "
            f"(M <= {ROWS_PER_BLOCK * MAX_GRID_Z})")
    if which == "splitk" and -(-n // SPLITK_COLS) > MAX_GRID_Z:
        raise ValueError(
            f"int8_matmul: N={n} needs {-(-n // SPLITK_COLS)} column tiles "
            f"of {SPLITK_COLS}; one launch takes at most {MAX_GRID_Z}")
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    if which == "tile" and tiles > MAX_GRID_X:
        raise ValueError(
            f"int8_matmul: [{m}, {n}] needs {tiles} output tiles of "
            f"{TILE_M} x {TILE_N}; one launch takes at most {MAX_GRID_X}")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    x_scale = x_scale.float().contiguous()
    w_scale = w_scale.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    requant = requant_scale is not None
    out = torch.empty((m, n), device=x_q.device,
                      dtype=torch.int8 if requant else torch.float32)
    tail = (_ACT_CODE[act], int(requant),
            reciprocal_f32(requant_scale) if requant else 0.0,
            build.stream(x_q))
    if which == "tile":
        lib = build.library("int8_matmul_tile")
        fn = lib.int8_matmul_tile
        fn.argtypes, fn.restype = _TILE_ARGTYPES, ctypes.c_int
        rc = fn(build.ptr(x_q), build.ptr(w_q), build.ptr(x_scale),
                build.ptr(w_scale), build.ptr(bias), build.ptr(out), m, k, n,
                ldw, *tail)
        build.check(lib, rc, "int8_matmul (tile)")
        launches_tile += 1
    else:
        lib = build.library("int8_matmul")
        scratch = _splitk_scratch(x_q.device, splitk_scratch_words(m, k, n))
        fn = lib.int8_matmul
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        rc = fn(build.ptr(x_q), build.ptr(w_q), build.ptr(x_scale),
                build.ptr(w_scale), build.ptr(bias), build.ptr(out),
                build.ptr(scratch), m, k, n, ldw, *tail)
        build.check(lib, rc, "int8_matmul (split-K)")
        launches_splitk += 1
    launches += 1
    return out if out.dtype == out_dtype else out.to(out_dtype)
