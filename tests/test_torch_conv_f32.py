"""The port's fp32 ``conv2d`` against the JAX reference's fp32 Pallas conv
(``kops.conv2d``, run in interpret mode on the CPU as the reference's own
tests run it), at the shapes the reference's tests sweep
(tests/test_kernels.py:57-62, tests/test_plans.py:190-200).

Tolerance: rtol = atol = 1e-4, the reference's own kernel tolerance. The
port's plain version sums the taps in the kernel's order but in PyTorch's
float32 matmul, the reference in XLA's; the two are not bit-identical.

On the card, ``tests/test_torch_gpu.py`` holds the CUDA kernel against this
plain version.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(b, h, w, cin, cout, kh, seed, wscale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((kh, kh, cin, cout)) * wscale).astype(
        np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("h,w,cin,cout,kh,stride,padding", [
    (16, 16, 3, 8, 3, 1, "SAME"),
    (16, 16, 3, 8, 3, 2, "SAME"),
    (12, 20, 4, 16, 5, 1, "VALID"),
    (128, 256, 3, 8, 3, 2, "SAME"),      # the VAE's first layer shape
    (9, 9, 2, 4, 3, 2, "VALID"),
])
def test_conv2d_plain_matches_reference_sweep(h, w, cin, cout, kh, stride,
                                              padding):
    x, wt, b = _case(2, h, w, cin, cout, kh, h * 31 + w)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(b), stride=stride,
                                  padding=padding, relu=True))
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                      torch.from_numpy(b), stride=stride, padding=padding,
                      relu=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("stride,padding", [
    (1, "SAME"), (2, "SAME"), (1, "VALID"), (2, "VALID")])
def test_conv2d_plain_matches_reference_plans_shapes(stride, padding):
    x, wt, b = _case(2, 14, 18, 3, 8, 3, stride * 7 + len(padding), 0.2)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(wt),
                                  jnp.asarray(b), stride=stride,
                                  padding=padding))
    got = tops.conv2d_plain(torch.from_numpy(x), torch.from_numpy(wt),
                            torch.from_numpy(b), stride=stride,
                            padding=padding)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv2d_without_bias_and_relu_matches_reference():
    x, wt, _ = _case(3, 11, 7, 5, 6, 3, 4)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(wt)))
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got < 0).any()                  # no relu unless asked


def test_conv2d_rejects_bad_operands_and_counts_no_cpu_launch():
    tops.reset_launch_counts()
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError):
        tops.conv2d(x, torch.zeros((3, 3, 4, 2)))
    with pytest.raises(ValueError):
        tops.conv2d(x, torch.zeros((3, 3, 3, 2)), torch.zeros(3))
    tops.conv2d(x, torch.zeros((3, 3, 3, 2)))
    assert tops.launch_counts()["conv2d"] == 0
