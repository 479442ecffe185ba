"""The port's kernel modules against the JAX reference kernels.

Each kernel's plain PyTorch version (what the wrapper runs for CPU
tensors) is held bit-exact against the Pallas kernel, run in interpret
mode on the CPU as the reference's own tests run it, over sweeps of
ragged shapes, strides, paddings, activations, bias and requant. Two
stated exceptions:

* sigmoid: the two libraries' exp differ by an ulp, so fp32 outputs agree
  to 1e-6 relative and requantized codes to one code;
* the bias add: the reference's XLA backend fuses it with the last
  dequant multiply (one rounding) for almost every element, and the
  port's kernels always do; elements the backend left unfused must equal
  the two-rounding value instead.

The CUDA kernels themselves run only on the card (``-m gpu``): there each
is held bit-exact against its plain version.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import numpy as np
import torch

from repro.kernels import ops as jops
from repro.kernels.conv2d import conv_geometry as j_conv_geometry
from repro_torch.kernels import build
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import int8_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels.epilogue import apply_epilogue, normalize_act

REQUANT = 0.0123456789


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _check(j, t, act, requant, dequant_terms=None):
    """Bit-exact, with the two exceptions of the module docstring.
    ``dequant_terms`` = (a, b, c) of the biased dequant ``a*b + c``."""
    assert j.shape == t.shape and j.dtype == t.dtype
    if act == "sigmoid":
        if requant is not None:
            assert np.abs(j.astype(np.int32) - t.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        return
    if dequant_terms is None:
        np.testing.assert_array_equal(t, j)
        return
    # each element is the port's (fused) result or the unfused rounding
    a, b, c = np.broadcast_arrays(*dequant_terms)
    unfused = apply_epilogue(torch.from_numpy(
        (a * b).astype(np.float32) + c), act, requant).numpy()
    ok = (j == t) | (j == unfused)
    assert ok.all(), f"{(~ok).sum()} elements match neither rounding"


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------


MATMUL_CASES = [
    # (m, k, n, act, requant, bias): ragged M/K/N, every epilogue variant
    (1, 5, 3, None, None, True), (1, 5, 3, "relu", REQUANT, False),
    (7, 33, 1, "sigmoid", None, True), (7, 33, 1, None, REQUANT, True),
    (16, 129, 92, "relu", REQUANT, True), (16, 129, 92, None, None, False),
    (16, 129, 92, "sigmoid", REQUANT, False),
    (20, 300, 130, "relu", None, True), (20, 300, 130, None, None, True),
    (20, 300, 130, "sigmoid", None, False)]


@pytest.mark.parametrize("m,k,n,act,requant,bias", MATMUL_CASES)
def test_int8_matmul_plain_matches_reference(m, k, n, act, requant, bias):
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.random(m) * 0.01 + 1e-3).astype(np.float32)
    ws = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    j = np.asarray(jops.int8_matmul(x, w, xs, ws, b, act=act,
                                    requant_scale=requant))
    t = tops.int8_matmul(_t(x), _t(w), _t(xs), _t(ws), _t(b), act=act,
                         requant_scale=requant).numpy()
    terms = None
    if bias:
        p = ((x.astype(np.int64) @ w.astype(np.int64)).astype(np.float32)
             * xs[:, None])
        terms = (p, ws[None, :], b[None, :])
    _check(j, t, act, requant, terms)


def test_int8_matmul_exact_int32_sums():
    """Unit scales and no bias expose the raw int32 sums: exact."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (9, 4099)).astype(np.int8)
    w = rng.integers(-127, 128, (4099, 17)).astype(np.int8)
    t = tops.int8_matmul(_t(x), _t(w), torch.ones(9), torch.ones(17))
    want = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(t.numpy().astype(np.int64), want)


def test_int8_matmul_rejects_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((9, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        tops.int8_matmul(x, w, torch.ones(4), torch.ones(3))
    with pytest.raises(ValueError):
        tops.int8_matmul(x.float(), w[:8], torch.ones(4), torch.ones(3))
    with pytest.raises(ValueError):
        normalize_act(True, "relu")


def test_int8_matmul_refuses_more_row_tiles_than_grid_z(monkeypatch):
    """The kernel puts M/16 row tiles on gridDim.z (at most 65,535): a
    larger M is refused with a clear error before anything launches."""
    monkeypatch.setattr(build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(build, "library", lambda name: pytest.fail(
        "reached the launch"))
    m = tmm.ROWS_PER_BLOCK * tmm.MAX_GRID_Z + 1
    x = torch.zeros((m, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="row tiles"):
        tmm.int8_matmul(x, torch.zeros((1, 2), dtype=torch.int8),
                        torch.ones(m), torch.ones(2))


def test_heuristic_blocks_copy():
    from repro.kernels.int8_matmul import heuristic_blocks as jhb
    for m, k, n in [(1, 5, 3), (16, 32769, 92), (200, 128, 1), (129, 7, 64)]:
        assert tmm.heuristic_blocks(m, k, n) == jhb(m, k, n)


# ---------------------------------------------------------------------------
# conv2d_int8
# ---------------------------------------------------------------------------


CONV_CASES = [
    # (b, h, w, cin, cout, kh, stride, padding, act, requant, bias)
    (2, 10, 9, 4, 3, 3, 2, "VALID", None, None, True),
    (2, 10, 9, 4, 3, 3, 1, "SAME", "relu", 0.05, True),
    (1, 9, 11, 2, 48, 3, 1, "SAME", "relu", 0.05, True),
    (1, 9, 11, 2, 48, 3, 2, "SAME", None, None, True),
    (1, 9, 11, 2, 48, 3, 2, "VALID", "sigmoid", None, True),
    (2, 8, 8, 5, 7, 1, 1, "VALID", "relu", None, False),
    (2, 8, 8, 5, 7, 1, 2, "SAME", None, 0.05, False),
    (1, 7, 12, 8, 16, 5, 1, "SAME", "sigmoid", 0.05, True),
    (1, 7, 12, 8, 16, 3, 2, "VALID", "relu", None, True),
    (1, 16, 16, 8, 8, 3, 1, "SAME", None, None, False)]


@pytest.mark.parametrize(
    "b,h,w,cin,cout,kh,stride,padding,act,requant,bias", CONV_CASES)
def test_conv2d_int8_plain_matches_reference(b, h, w, cin, cout, kh, stride,
                                             padding, act, requant, bias):
    rng = np.random.default_rng(b * 1000 + h * 100 + w * 10 + cin + stride)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (kh, kh, cin, cout)).astype(np.int8)
    ws = (rng.random(cout) * 0.01).astype(np.float32)
    bb = rng.standard_normal(cout).astype(np.float32) if bias else None
    kw = dict(x_scale=0.0377, stride=stride, padding=padding, act=act,
              requant_scale=requant)
    j = np.asarray(jops.conv2d_int8(x, wq, ws, bb, **kw))
    t = tops.conv2d_int8(_t(x), _t(wq), _t(ws), _t(bb), **kw).numpy()
    terms = None
    if bias:
        acc = tops.conv2d_int8(_t(x), _t(wq), torch.ones(cout),
                               x_scale=1.0, stride=stride,
                               padding=padding).numpy()
        terms = (acc, ws * np.float32(0.0377), bb)
    _check(j, t, act, requant, terms)


@pytest.mark.parametrize("h,w,kh,kw,stride,padding,rows", [
    (h, w, k, k, s, p, r)
    for h, w in [(1, 1), (7, 5), (16, 16), (33, 20), (256, 256)]
    for k in (1, 2, 3, 5) for s in (1, 2) for p in ("SAME", "VALID")
    for r in (1, 8) if p == "SAME" or (h >= k and w >= k)])
def test_conv_geometry_copy(h, w, kh, kw, stride, padding, rows):
    assert (tuple(tconv.conv_geometry(h, w, kh, kw, stride, padding, rows))
            == tuple(j_conv_geometry(h, w, kh, kw, stride, padding, rows)))


def test_pad_input_matches_geometry():
    x = torch.arange(2 * 5 * 6 * 3, dtype=torch.float32).reshape(2, 5, 6, 3)
    g = tconv.conv_geometry(5, 6, 3, 3, 2, "SAME", 4)
    xp = tconv.pad_input(x, g)
    assert tuple(xp.shape) == (2, g.h_pad, g.w_pad, 3)
    assert torch.equal(xp[:, g.pad_top:g.pad_top + 5,
                          g.pad_left:g.pad_left + 6], x)
    assert float(xp.abs().sum()) == float(x.abs().sum())


# ---------------------------------------------------------------------------
# quantize_apply / quantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [
    (18, 48), (433, 48), (92, 1), (257, 3),
    # both vector widths: N % 4 == 0 and not, N = 1, M = 1, N = 4097
    (64, 64), (37, 12), (9, 6), (33, 1), (1, 48), (1, 1), (1, 4097),
    (3, 4097)])
def test_quantize_matches_reference(m, n):
    """Codes and scales bit-exact — including where multiplying by the
    reciprocal and dividing disagree by one code."""
    rng = np.random.default_rng(m + n)
    x = (rng.standard_normal((m, n)) * rng.random(n) * 3).astype(np.float32)
    qj, sj = jops.quantize(x)
    qt, st = tops.quantize(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("m,n", [(33, 8), (5, 1), (2, 4097), (40, 3)])
def test_quantize_zero_and_negative_zero_columns(m, n):
    """A column of zeros (scale 1e-12), one of -0.0 and a stray -0.0:
    codes and scales bit-exact to the reference."""
    rng = np.random.default_rng(m * n)
    x = rng.standard_normal((m, n)).astype(np.float32)
    x[:, 0] = 0.0
    x[:, -1] = -0.0
    x[0, n // 2] = -0.0
    qj, sj = jops.quantize(x)
    qt, st = tops.quantize(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert st[0] == np.float32(1e-12) and st[-1] == np.float32(1e-12)


def test_quantize_apply_uses_the_reciprocal():
    """Values where x * (1/s) and x / s round to different codes: the
    port follows the reference kernel (the reciprocal)."""
    s = np.float32(0.0123456789)
    inv = np.float32(1.0) / s
    cand = np.random.default_rng(2).uniform(-1.5, 1.5, 4_000_000
                                             ).astype(np.float32)
    diff = cand[np.round(cand / s) != np.round(cand * inv)][:32]
    assert diff.size > 0
    x = np.ascontiguousarray(diff[:, None])
    scale = np.array([s], np.float32)
    j = np.asarray(jops._quant.quantize_apply(x, scale))
    t = tquant.quantize_apply(_t(x), _t(scale)).numpy()
    np.testing.assert_array_equal(t, j)
    assert not np.array_equal(t[:, 0], np.clip(np.round(diff / s), -127, 127))


def test_quantize_per_tensor():
    x = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    qj, sj = jops.quantize(x, axis=None)
    qt, st = tops.quantize(_t(x), axis=None)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, and only they do
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tops.reset_launch_counts()
    x = torch.zeros((2, 3), dtype=torch.int8)
    tops.int8_matmul(x, torch.zeros((3, 4), dtype=torch.int8),
                     torch.ones(2), torch.ones(4))
    tops.conv2d_int8(torch.zeros((1, 4, 4, 2), dtype=torch.int8),
                     torch.zeros((3, 3, 2, 5), dtype=torch.int8),
                     torch.ones(5))
    tops.quantize(torch.randn(7, 3))
    q = torch.randn(1, 5, 2, 8)
    tops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    tops.ssd(torch.randn(1, 6, 2, 4), torch.randn(1, 6, 3),
             torch.randn(1, 6, 3), torch.rand(1, 6, 2), -torch.rand(2))
    tops.conv2d_int8(torch.zeros((1, 4, 4, 2), dtype=torch.int8),
                     torch.zeros((3, 3, 2, 20), dtype=torch.int8),
                     torch.ones(20), cout_per_block=8)
    tops.conv2d(torch.zeros((1, 4, 4, 2)), torch.zeros((3, 3, 2, 5)))
    tops.sample_normal(torch.zeros(2, 6), torch.zeros(2, 6),
                       torch.zeros(2, 2, dtype=torch.int64))
    assert tops.launch_counts() == {"int8_matmul": 0, "conv2d_int8": 0,
                                    "conv2d_int8_cout_blocks": 0,
                                    "conv2d": 0, "quantize_apply": 0,
                                    "flash_attention": 0, "ssd": 0,
                                    "sample_normal": 0}


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        build.on_cpu(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        build.on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))


def test_build_names_every_source():
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).is_file(), src
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)


def test_epilogue_helpers_match_reference():
    from repro.kernels import epilogue as jepi
    from repro_torch.kernels import epilogue as tepi
    ws = np.array([0.5, 2.0, 3.0], np.float32)
    b = np.array([1.0, -1.0, 0.25], np.float32)
    for n_pad in (0, 3):
        jw, jb = jepi.pad_channel_params(ws, b, n_pad)
        tw, tb = tepi.pad_channel_params(_t(ws), _t(b), n_pad)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    tw, tb = tepi.pad_channel_params(_t(ws), None, 2)
    assert tb is None and tw.tolist() == [0.5, 2.0, 3.0, 1.0, 1.0]
    assert tepi.out_dtype_for(0.1) == torch.int8
    assert tepi.out_dtype_for(None) == torch.float32
    for relu, act in ((False, None), (True, None), (False, "sigmoid")):
        assert tepi.normalize_act(relu, act) == jepi.normalize_act(relu, act)
    with pytest.raises(ValueError):
        tepi.normalize_act(False, "tanh")
    # compiled, as inside the reference kernels (the requant then
    # multiplies by the reciprocal, as the port does)
    import jax
    x = np.linspace(-3, 3, 1001, dtype=np.float32)
    for act in (None, "relu"):
        for rq in (None, 0.02):
            j = np.asarray(jax.jit(lambda v: jepi.apply_epilogue(
                v, act, rq))(x))
            t = tepi.apply_epilogue(_t(x), act, rq).numpy()
            np.testing.assert_array_equal(t.astype(np.float32), j)
