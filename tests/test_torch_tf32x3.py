"""The numerics of csrc/flash_attention.cu's 3xTF32 split, emulated on the
CPU: both attention products done on TF32 operands split into big and
small hold the port's 2e-5 against the fp32 plain version, and TF32 alone
does not. So the design meets the tolerance before any run on the card.

TF32 keeps 10 of fp32's 23 mantissa bits. Two splits are emulated on the
int32 view: ``cvt.rna.tf32.f32``'s (round to nearest, ties away from
zero: add half of the 13 dropped bits to the magnitude, then clear them;
``small`` rounded the same way), and the kernel's (``big`` = x with the
low 13 bits cleared, ``small = x - big``, of which the tensor cores read
the top 19 bits: emulated as truncation, the worse of the roundings they
could apply). A TF32 x TF32 product is exact in fp32 (11 x 11 significant
bits); the emulation forms each product matrix in float64 and rounds its
sums to fp32, as the tensor cores accumulate in fp32."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.epilogue import f32
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain

TOL = 2e-5          # the kernel's tolerance against its plain version


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32, nearest with ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """Truncate fp32 to TF32 (clear the low 13 bits)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def split(x: torch.Tensor):
    """cvt.rna's split: big and small both rounded to nearest."""
    big = tf32(x)
    return big, tf32(x - big)


def split_trunc(x: torch.Tensor):
    """The kernel's split: big truncated, small = x - big (exact), read
    by the tensor cores as its top 19 bits."""
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def mm_3x(splitter):
    def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in 3xTF32: small terms first, small x small dropped,
        each product matrix accumulated in fp32."""
        ab, as_ = splitter(a)
        bb, bs = splitter(b)
        def mm(x, y):
            return (x.double() @ y.double()).float()
        return (mm(as_, bb) + mm(ab, bs)) + mm(ab, bb)
    return mm3


mm_3xtf32 = mm_3x(split)
mm_3xtf32_trunc = mm_3x(split_trunc)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (tf32(a).double() @ tf32(b).double()).float()


def attention(q, k, v, causal, mm):
    """[B, S, H, hd] attention with both products done by ``mm``."""
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[3]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))      # [B,H,S,hd]
    s = mm(qt, kt.transpose(-1, -2)) * f32(hd ** -0.5)
    if causal:
        keep = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = mm(p, vt) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.transpose(1, 2)


def test_tf32_rounding_is_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10                        # TF32's ulp at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    big, small = split(torch.tensor([1 + 2 ** -20]))
    assert float(big) == 1.0 and float(small) == 2.0 ** -20
    assert torch.equal(tf32(one), one)
    # truncation: 1 + 1.5 ulp keeps 1 + ulp, and small carries the rest
    big, small = split_trunc(torch.tensor([1 + 1.5 * ulp]))
    assert float(big) == 1 + ulp and float(small) == ulp / 2


def _inputs(hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, 256, 4, hd))
                             .astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("mm", [mm_3xtf32, mm_3xtf32_trunc],
                         ids=["rna", "kernel_trunc"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_holds_the_fp32_tolerance(hd, causal, mm):
    q, k, v = _inputs(hd, hd + causal)
    want = flash_attention_plain(q, k, v, causal)
    got = attention(q, k, v, causal, mm)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_1xtf32_attention_breaks_the_fp32_tolerance(hd, causal):
    q, k, v = _inputs(hd, hd + causal)
    want = flash_attention_plain(q, k, v, causal)
    got = attention(q, k, v, causal, mm_1xtf32)
    err = float((got - want).abs().max())
    assert err > 5 * TOL, err
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
