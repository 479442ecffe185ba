"""Causal / non-causal GQA attention with an online softmax (flash
attention), fp32 inside, the output in the query's dtype.

Replaces the Pallas kernel ``flash_attention`` (src/repro/kernels/
flash_attention.py, ``_kernel``) with ``csrc/flash_attention.cu``: one
block of 8 warps per (128-row query tile, head, batch) walks the K/V tiles
(double-buffered, fetched with ``cp.async``) in a loop that takes the
place of the TPU's sequential grid axis, keeping the running max, sum and
accumulator in registers. Both products run on
the tensor cores (``mma.sync`` m16n8k8 TF32) as a 3xTF32 split: each
operand is ``big + small`` with ``big`` = x truncated to TF32 and ``small
= x - big``, and ``a*b ~ small_a*big_b + big_a*small_b + big_a*big_b``,
which keeps fp32 accuracy (TF32 alone does not hold the port's 2e-5;
``tests/test_torch_tf32x3.py`` emulates both on the CPU). At the served
shape the work is bound by that arithmetic, not by memory (see the
source's note).

Semantics, shared by the kernel and :func:`flash_attention_plain`: scores
``(q . k) * hd**-0.5``; causal masking keeps ``qpos >= kpos`` with both
positions counted from 0 (top-left aligned, so ``Sq != Sk`` is allowed);
masked scores are ``-2e38``; the output is ``acc / max(l, 1e-30)``, computed in fp32 and rounded
once to ``q``'s dtype (the reference's ``.astype(o_ref.dtype)``; bf16
inputs are widened to fp32 before the launch). Query head ``h`` reads K/V
head ``h // (Hq // Hkv)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import f32

# launches of the CUDA kernel (the plain version does not count)
launches = 0

NEG_INF = -2.0e38
MAX_HEAD_DIM = 128

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]
            or k.shape[1] < 1):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} [B,Sq,Hq,hd], k "
            f"{tuple(k.shape)} and v {tuple(v.shape)} [B,Sk,Hkv,hd] with "
            f"Hq a multiple of Hkv")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The same function as one masked fp32 softmax per batch row (the
    [Hq, Sq, Sk] scores of one row at a time bound its memory)."""
    _check(q, k, v)
    b, sq, hq, hd = q.shape
    sk, group = k.shape[1], hq // k.shape[2]
    scale = f32(hd ** -0.5)
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    out = torch.empty((b, sq, hq, hd), dtype=torch.float32, device=q.device)
    for i in range(b):
        qi = q[i].float().transpose(0, 1)                      # [Hq,Sq,hd]
        ki = k[i].float().repeat_interleave(group, 1).transpose(0, 1)
        vi = v[i].float().repeat_interleave(group, 1).transpose(0, 1)
        scores = torch.matmul(qi, ki.transpose(1, 2)) * scale   # [Hq,Sq,Sk]
        if keep is not None:
            scores = torch.where(keep, scores, NEG_INF)
        m = scores.amax(-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[i] = (torch.matmul(p, vi) / l).transpose(0, 1)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 256,
                    bk: int = 256) -> torch.Tensor:
    """``q`` [B, Sq, Hq, hd], ``k``/``v`` [B, Sk, Hkv, hd] -> [B, Sq, Hq,
    hd] in ``q``'s dtype. ``bq``/``bk`` are the reference's block sizes, kept for
    parity: they do not change the result (the kernel's tiles are 64).
    Refuses a gradient, on the CPU too (``build.refuse_grad``). On
    ``meta`` tensors it returns the output's shape and launches nothing."""
    build.refuse_grad("flash_attention", q, k, v, cpu_too=True)
    _check(q, k, v)
    if q.is_meta:                     # shapes only (the dry-run): no launch
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal)
    global launches
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    dtype = q.dtype
    q, k, v = (t.float() for t in (q, k, v))
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, hq, hd), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in t.stride()[:3]))
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), b, sq,
            sk, hq, hkv, hd, strides, f32(hd ** -0.5), int(causal),
            build.stream(q))
    build.check(lib, rc, "flash_attention")
    launches += 1
    return out.to(dtype)
