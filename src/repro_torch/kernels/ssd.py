"""Mamba-2 SSD (state-space duality) chunked scan, fp32 inside; ``y`` in
``x``'s dtype (rounded once from fp32, as the reference's
``.astype(y_ref.dtype)``), the final state fp32.

Replaces the Pallas kernel ``ssd`` (src/repro/kernels/ssd.py, ``_kernel``)
with ``csrc/ssd.cu``: the TPU walks the chunks of each (batch, head) on a
sequential grid axis with the [P, N] state in VMEM; here the chunks run
in parallel. One call is three launches: each chunk's own state
contribution (a [P, Q] x [Q, N] product per (chunk, head, batch)), a pass
over the chunks that carries the state and writes the final state, and
``y`` per 64-row strip of each chunk. The products run as 3xTF32
``mma.sync`` on the tensor cores, and arithmetic bounds the work at the
served shape (see the source's note).

Per chunk of ``Q`` positions (``Q`` is ``chunk``, or the largest divisor
of ``S`` below it, as the reference chooses), shared by the kernel and
:func:`ssd_plain`::

    a = dt * A          cum = cumsum(a)
    L = tril(exp(cum_i - cum_j))
    y = ((C @ B^T) * L * dt_j) @ x + exp(cum) * (C @ state^T)
    state = state * exp(cum[-1]) + ((x * exp(cum[-1] - cum) * dt)^T @ B)
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (the plain version does not count)
launches = 0

MAX_P = 64
MAX_N = 128
MAX_GRID_YZ = 65535             # heads ride on gridDim.y, batch on .z

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def chunk_size(s: int, chunk: int) -> int:
    """The chunk the scan uses: ``chunk``, or the largest divisor of ``s``
    not above it (the reference's fallback, so both associate alike)."""
    if s % chunk:
        chunk = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
    return chunk


def _check(x, B_, C_, dt, A, init_state) -> None:
    b, s, h, p = x.shape
    n = B_.shape[-1]
    want = {"B_": (b, s, n), "C_": (b, s, n), "dt": (b, s, h), "A": (h,)}
    got = {"B_": tuple(B_.shape), "C_": tuple(C_.shape),
           "dt": tuple(dt.shape), "A": tuple(A.shape)}
    if init_state is not None:
        want["init_state"] = (b, h, p, n)
        got["init_state"] = tuple(init_state.shape)
    if got != want or s < 1:
        raise ValueError(f"ssd: x {tuple(x.shape)} [B,S,H,P] with {got}, "
                         f"want {want}")


def ssd_plain(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
              dt: torch.Tensor, A: torch.Tensor,
              init_state: Optional[torch.Tensor] = None,
              chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same chunked algorithm in tensor ops, one chunk at a time: in
    fp32, or in float64 for float64 inputs (an exact yardstick)."""
    _check(x, B_, C_, dt, A, init_state)
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = chunk_size(s, chunk)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    state = (torch.zeros((b, h, p, n), dtype=acc, device=x.device)
             if init_state is None else init_state.to(acc))
    a_h = A.to(acc)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, s, q):
        xc = x[:, c0:c0 + q].to(acc)                         # [b,q,h,p]
        bc = B_[:, c0:c0 + q].to(acc)                        # [b,q,n]
        cc = C_[:, c0:c0 + q].to(acc)
        dtc = dt[:, c0:c0 + q].to(acc)                       # [b,q,h]
        cum = torch.cumsum(dtc * a_h, dim=1)
        li = cum[:, :, None, :] - cum[:, None, :, :]         # [b,i,j,h]
        L = torch.where(tri[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        M = scores[..., None] * L * dtc[:, None, :, :]       # [b,i,j,h]
        y = torch.einsum("bijh,bjhp->bihp", M, xc)
        y_in = torch.einsum("bin,bhpn->bihp", cc, state)
        ys.append(y + torch.exp(cum)[..., None] * y_in)
        suffix = torch.exp(cum[:, -1:, :] - cum) * dtc       # [b,q,h]
        s_new = torch.einsum("bjhp,bjn->bhpn", xc * suffix[..., None], bc)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + s_new
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd(x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        dt: torch.Tensor, A: torch.Tensor,
        init_state: Optional[torch.Tensor] = None, *,
        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. ``x`` [B,S,H,P], ``B_``/``C_`` [B,S,N], ``dt``
    [B,S,H] (already positive), ``A`` [H] (negative), ``init_state``
    [B,H,P,N] or None. Returns (y [B,S,H,P] in ``x``'s dtype,
    final_state [B,H,P,N] float32). Refuses a gradient, on the CPU too
    (``build.refuse_grad``): :func:`repro_torch.nn.ssm.ssd_chunked` is
    the differentiable scan. On ``meta`` tensors it returns the outputs'
    shapes and launches nothing."""
    build.refuse_grad("ssd", x, B_, C_, dt, A, init_state, cpu_too=True)
    _check(x, B_, C_, dt, A, init_state)
    if x.is_meta:                     # shapes only (the dry-run): no launch
        b, _, h, p = x.shape
        return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                torch.empty((b, h, p, B_.shape[-1]), dtype=torch.float32,
                            device="meta"))
    if build.on_cpu(x, B_, C_, dt, A, init_state):
        return ssd_plain(x, B_, C_, dt, A, init_state, chunk)
    global launches
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if p > MAX_P or n > MAX_N or max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"ssd: P={p} (<= {MAX_P}), N={n} (<= {MAX_N}), "
                         f"B={b} and H={h} (<= {MAX_GRID_YZ})")
    q = chunk_size(s, chunk)
    dtype = x.dtype
    x, B_, C_, dt, A = (t.float().contiguous() for t in (x, B_, C_, dt, A))
    if init_state is not None:
        init_state = init_state.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # the per-chunk states and each chunk's last cum (no zeroing needed)
    scratch = torch.empty(b * h * (s // q) * (p * n + 1),
                          dtype=torch.float32, device=x.device)
    lib = build.library("ssd")
    fn = lib.ssd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(x), build.ptr(B_), build.ptr(C_), build.ptr(dt),
            build.ptr(A), build.ptr(init_state), build.ptr(y),
            build.ptr(final), build.ptr(scratch), b, s, h, p, n, q,
            build.stream(x))
    build.check(lib, rc, "ssd")
    launches += 1
    return y.to(dtype), final
