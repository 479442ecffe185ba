"""The LM slice's kernel modules and KV quantizer against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both packages; the
reference's Pallas kernels run in interpret mode on the CPU, as its own
tests run them. Tolerances are the reference's own:

* ``flash_attention_plain``: 2e-5 (rtol and atol), the bound the
  reference holds its kernel to (tests/test_kernels.py);
* ``ssd_plain``: 1e-4, the reference's kernel-vs-chunked bound
  (tests/test_ssd_kernel.py): both run the same chunked algorithm, and
  sum in different orders;
* ``quantize_kv`` / ``dequantize_kv``: bit-exact against the reference as
  its serving path runs them (compiled);
* bf16 inputs: both kernels return the input's dtype (the final SSD state
  stays fp32), each element within one bf16 ulp of the reference's
  (both compute in fp32 and round once; a last-bit fp32 difference can
  move that rounding by one ulp).

The CUDA kernels run only on the card (``-m gpu``, tests/test_torch_gpu.py).
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import lm_quant as j_lmq
from repro.kernels import ops as jops
from repro_torch.core import lm_quant as t_lmq
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as tssd


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16(a):
    """The same bf16 values in both packages (both round to nearest
    even)."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def assert_within_one_bf16_ulp(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.float32(2 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
@pytest.mark.parametrize("s", [37, 64])
@pytest.mark.parametrize("hd", [8, 16])
def test_flash_attention_plain_matches_reference(causal, hq, hkv, s, hd):
    rng = np.random.default_rng(s * 100 + hq * 10 + hd)
    q, k, v = _np(rng, 2, s, hq, hd), _np(rng, 2, s, hkv, hd), \
        _np(rng, 2, s, hkv, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=32, bk=32))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               bq=32, bk=32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(20, 45), (45, 20)])
def test_flash_attention_plain_unequal_lengths(sq, sk):
    """Sq != Sk: causal positions are top-left aligned in both packages."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = _np(rng, 1, sq, 4, 8), _np(rng, 1, sk, 2, 8), \
        _np(rng, 1, sk, 2, 8)
    for causal in (True, False):
        want = np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            bq=16, bk=16))
        got = tflash.flash_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hq,hkv,s", [(4, 2, 37), (2, 2, 64)])
def test_flash_attention_bf16_returns_bf16(hq, hkv, s):
    rng = np.random.default_rng(s + hq)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(_np(rng, 2, s, h, 16))
                                    for h in (hq, hkv, hkv))
    want = jops.flash_attention(qj, kj, vj, causal=True, bq=32, bk=32)
    got = tops.flash_attention(qt, kt, vt, causal=True, bq=32, bk=32)
    assert_within_one_bf16_ulp(got, want)


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention(q, torch.zeros((1, 4, 2, 8)),
                             torch.zeros((1, 4, 2, 8)))
    with pytest.raises(ValueError):
        tops.flash_attention(q, torch.zeros((1, 4, 3, 4)),
                             torch.zeros((1, 4, 3, 4)))


# ---------------------------------------------------------------------------
# ssd
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b, s, h, p, n, init):
    x, B_, C_ = _np(rng, b, s, h, p), _np(rng, b, s, n), _np(rng, b, s, n)
    dt = (rng.random((b, s, h)) * 0.5 + 0.05).astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, h)).astype(np.float32)
    st = _np(rng, b, h, p, n) if init else None
    return x, B_, C_, dt, A, st


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 64), (37, 256)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_plain_matches_reference(s, chunk, init):
    """y and the final state, with a chunk that divides S and two that
    fall back to the largest divisor (48, and 37 itself)."""
    rng = np.random.default_rng(s + chunk + int(init))
    x, B_, C_, dt, A, st = _ssd_inputs(rng, 2, s, 3, 8, 16, init)
    yj, fj = jops.ssd(*map(jnp.asarray, (x, B_, C_, dt, A)),
                      None if st is None else jnp.asarray(st), chunk=chunk)
    yt, ft = tops.ssd(*map(torch.from_numpy, (x, B_, C_, dt, A)),
                      None if st is None else torch.from_numpy(st),
                      chunk=chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 256)])
def test_ssd_bf16_returns_bf16_and_an_fp32_state(s, chunk):
    rng = np.random.default_rng(s)
    x, B_, C_, dt, A, st = _ssd_inputs(rng, 2, s, 3, 8, 16, True)
    (xj, xt), (bj, bt), (cj, ct) = (_bf16(a) for a in (x, B_, C_))
    yj, fj = jops.ssd(xj, bj, cj, jnp.asarray(dt), jnp.asarray(A),
                      jnp.asarray(st), chunk=chunk)
    yt, ft = tops.ssd(xt, bt, ct, torch.from_numpy(dt), torch.from_numpy(A),
                      torch.from_numpy(st), chunk=chunk)
    assert_within_one_bf16_ulp(yt, yj)
    assert ft.dtype == torch.float32 and fj.dtype == jnp.float32
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 64), (37, 256),
                                     (2048, 256), (1000, 256), (7, 4)])
def test_chunk_size_is_the_references_fallback(s, chunk):
    want = chunk
    if s % chunk:
        want = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
    assert tssd.chunk_size(s, chunk) == want


def test_ssd_rejects_bad_operands():
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="ssd"):
        tops.ssd(x, torch.zeros((1, 8, 3)), torch.zeros((1, 8, 3)),
                 torch.zeros((1, 8, 3)), torch.zeros(2))


# ---------------------------------------------------------------------------
# the int8 KV quantizer
# ---------------------------------------------------------------------------


def _kv_cases():
    rng = np.random.default_rng(0)
    mixed = _np(rng, 1, 4, 2, 8)
    mixed[0, 1] = 0.0
    mixed[0, 3, 0] = 0.0
    return {"random": _np(rng, 3, 40, 4, 16) * 3.0,
            "zeros": np.zeros((2, 5, 3, 8), np.float32),
            "mixed_zero_rows": mixed,
            "tiny": _np(rng, 2, 6, 2, 8) * np.float32(1e-30)}


@pytest.mark.parametrize("case", sorted(_kv_cases()))
def test_quantize_kv_bit_exact(case):
    x = _kv_cases()[case]
    qj, sj = jax.jit(j_lmq.quantize_kv)(jnp.asarray(x))
    qt, st = t_lmq.quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the f16 scale plane the KV arena stores, and the round trip
    s16 = st.to(torch.float16)
    np.testing.assert_array_equal(s16.numpy(),
                                  np.asarray(sj).astype(np.float16))
    back_j = jax.jit(j_lmq.dequantize_kv, static_argnums=2)(
        qj, jnp.asarray(s16.numpy()), jnp.float32)
    back_t = t_lmq.dequantize_kv(qt, s16, torch.float32)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_quantize_kv_zero_tiles_get_scale_one():
    q, s = t_lmq.quantize_kv(torch.zeros((2, 5, 3, 8)))
    assert torch.equal(q, torch.zeros_like(q))
    assert torch.equal(s, torch.ones_like(s))
    back = t_lmq.dequantize_kv(q, s.to(torch.float16), torch.float32)
    assert torch.equal(back, torch.zeros_like(back))


def test_quantize_kv_scale_is_the_compiled_references():
    """The reference's scale ``absmax / 127`` is ``absmax * f32(1/127)``
    once compiled (the form its serving path runs) and a true division
    when run op by op; the port takes the compiled form. Codes agree
    either way on these inputs."""
    x = _kv_cases()["random"]
    _, s_eager = j_lmq.quantize_kv(jnp.asarray(x))
    _, s_jit = jax.jit(j_lmq.quantize_kv)(jnp.asarray(x))
    _, st = t_lmq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(st.numpy(), np.asarray(s_jit))
    np.testing.assert_allclose(st.numpy(), np.asarray(s_eager), rtol=2e-7,
                               atol=0)
