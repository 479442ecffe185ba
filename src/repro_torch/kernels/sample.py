"""The VAE's reparameterised Gaussian sample, ``z = mu + exp(0.5 * logvar)
* eps``, with eps drawn exactly as ``jax.random.normal`` draws it.

``sample_normal`` replaces no Pallas kernel: the reference draws eps with
XLA's RNG (``jax.random.normal`` per sample key, src/repro/core/plan.py,
``_sample_normal_b``). PyTorch has no threefry, and its own generators
(Philox) give other numbers, so the port computes the reference's bits
itself: for a raw key ``(k0, k1)`` element ``i`` of a sample's flat shape
takes ``(x0, x1) = threefry2x32((k0, k1), (0, i))`` (20 rounds, the key
schedule's third word ``k0 ^ k1 ^ 0x1BD11BDA``), ``bits = x0 ^ x1``, a
float ``f`` in [0, 1) from the top 23 bits, ``u = max(lo, 2 f + lo)``
with ``lo = nextafter(-1, 0)``, and ``eps = sqrt(2) * erfinv(u)``.
``split`` is ``jax.random.split`` on raw keys: key ``j`` of a split is
``threefry2x32(key, (0, j))``. ``erfinv`` is the one XLA lowers
``erf_inv`` to for float32 (Giles' single-precision polynomial in
``w = -log1p(-u^2)``, Horner steps as fused multiply-adds): the
libraries' own erfinv differ from it by up to ~50 ulps in the tails. The
bits are exact; ``log1p`` and ``exp`` are the platform's, so eps and the
sample may differ from XLA's by an ulp or two.

``csrc/sample_normal.cu`` runs one thread per element: the threefry, the
float, ``erfinvf``, ``expf`` and the multiply-add in one launch. At the
VAE's shape (16 samples of 6) the launch is a few hundred bytes and ~100
integer operations a thread: its floor is the launch itself.

The plain versions compute the same uint32 arithmetic in int64 tensors
(or numpy uint64 arrays) masked to 32 bits, and the same polynomial.
Keys are ``[..., 2]`` integer arrays holding uint32 values.

The sample is differentiable in ``mu`` and ``logvar`` (QAT distils
through it): :class:`SampleNormal` carries it on either device. On the
card it wraps the launch, and when a gradient is needed the kernel also
writes the eps it draws; on the CPU its forward is the plain version's
arithmetic. The backward pass is plain PyTorch, ``dmu = g`` and
``dlogvar = 0.5 g exp(0.5 logvar) eps`` (what ``jax.grad`` of the
reference's expression gives; ``z - mu`` would cancel when |mu| >>
std). The keys get no gradient.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import fma_f32

# launches of the CUDA kernel (the plain version does not count)
launches = 0

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# nextafter(-1, 0) and sqrt(2) in float32, as jax.random.normal uses them
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))
# Giles' erfinv coefficients, highest power first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64 tensors
    or uint64 numpy arrays (broadcasting); returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def split(keys, num: int = 2) -> np.ndarray:
    """``jax.random.split`` of raw host keys ``[..., 2]`` into
    ``[..., num, 2]`` (uint64 numpy: a few dozen array operations)."""
    k = np.asarray(keys).astype(np.uint64)
    j = np.arange(num, dtype=np.uint64)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], np.zeros_like(j), j)
    return np.stack([y0, y1], axis=-1)


def split_keys(keys: torch.Tensor):
    """``(carried, sub)``: the two halves of each row's split of the host
    key array ``keys`` [B, 2], as the reference's plan takes them for every
    random op (the plan's keys live on the host)."""
    both = torch.from_numpy(split(keys.numpy()).astype(np.int64))
    return both[:, 0], both[:, 1]


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row of ``keys`` [B, 2]: [B, n]
    uint32 values in int64."""
    k = keys.to(torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(i), i)
    return y0 ^ y1


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it (Giles' polynomial)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).float()

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,))`` per row of ``keys``: [B, n] f32."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * 2.0 + _LO, _LO)
    return erfinv_f32(u) * _SQRT2


def _check(mu, logvar, keys):
    if (mu.shape != logvar.shape or mu.ndim < 1
            or tuple(keys.shape) != (mu.shape[0], 2)):
        raise ValueError(f"sample_normal: mu {tuple(mu.shape)}, logvar "
                         f"{tuple(logvar.shape)}, keys {tuple(keys.shape)}")


def _eps_plain(mu: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    eps = normal_plain(keys.to(mu.device), math.prod(mu.shape[1:]))
    return eps.reshape(mu.shape)


def sample_normal_plain(mu: torch.Tensor, logvar: torch.Tensor,
                        keys: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch on ``mu``'s device."""
    _check(mu, logvar, keys)
    return (mu.float() + torch.exp(0.5 * logvar.float())
            * _eps_plain(mu, keys))


def _key_words(keys: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The keys' uint32 words as int32 bit patterns on ``device`` (a
    non-blocking copy: the stream does not wait for it)."""
    k = keys.to(torch.int64)
    k = torch.where(k >= 2 ** 31, k - 2 ** 32, k).to(torch.int32)
    return k.contiguous().to(device, non_blocking=True)


def _launch(mu, logvar, words, out, bits_only: bool, eps=None) -> None:
    global launches
    lib = build.library("sample_normal")
    fn = lib.sample_normal
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(build.ptr(mu), build.ptr(logvar), build.ptr(words),
            build.ptr(out), build.ptr(eps), out.shape[0],
            math.prod(out.shape[1:]), int(bits_only), build.stream(out))
    build.check(lib, rc, "sample_normal")
    launches += 1


class SampleNormal(torch.autograd.Function):
    """``z = mu + exp(0.5 logvar) eps`` with a gradient for ``mu`` and
    ``logvar``: the kernel forward on the card (the plain arithmetic on
    the CPU, in ``mu``'s dtype), the backward in plain PyTorch from the
    eps the forward drew."""

    @staticmethod
    def forward(ctx, mu, logvar, keys):
        need_eps = ctx.needs_input_grad[1]
        if build.on_cpu(mu, logvar):
            eps = _eps_plain(mu, keys).to(mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps
        else:
            mu = mu.float().contiguous()
            logvar = logvar.float().contiguous()
            z = torch.empty_like(mu)
            eps = torch.empty_like(mu) if need_eps else None
            _launch(mu, logvar, _key_words(keys, mu.device), z, False, eps)
        if need_eps:
            ctx.save_for_backward(logvar, eps)
        return z

    @staticmethod
    def backward(ctx, g):
        dlogvar = None
        if ctx.needs_input_grad[1]:
            logvar, eps = ctx.saved_tensors
            # autograd's (and jax.grad's) order through the expression
            dlogvar = g * eps * torch.exp(0.5 * logvar) * 0.5
        return (g if ctx.needs_input_grad[0] else None), dlogvar, None


def sample_normal(mu: torch.Tensor, logvar: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """``mu``/``logvar`` [B, ...] float32, ``keys`` [B, 2] raw per-sample
    keys (uint32 values, any integer type, on any device) -> [B, ...]
    float32, differentiable in ``mu`` and ``logvar``. The device of ``mu``
    chooses the path."""
    _check(mu, logvar, keys)
    return SampleNormal.apply(mu, logvar, keys)


def random_bits_kernel(keys: torch.Tensor, n: int,
                       device: torch.device) -> torch.Tensor:
    """The kernel's own threefry bits for ``n`` elements a key on the
    card ``device``: [B, n] uint32 values in int64, to hold against
    :func:`random_bits`."""
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=device)
    _launch(None, None, _key_words(keys, out.device), out, True)
    return out.view(torch.int32).to(torch.int64) & _M32
