"""The port's Gaussian sampler (``kernels/sample.py``) against JAX's RNG.

The reference draws the VAE's eps with ``jax.random.normal`` per sample
key and splits each key before every random op
(src/repro/core/plan.py). The port computes the same threefry-2x32 bits
itself. Held here on the CPU:

* ``split`` and ``random_bits`` equal ``jax.random.split`` and
  ``jax.random.bits`` bit for bit, over many keys and counters;
* ``erfinv_f32`` (XLA's float32 polynomial) and ``normal_plain`` hold to
  ``lax.erf_inv`` and ``jax.random.normal``, and ``sample_normal_plain``
  to the reference's batched op, within 2e-6 relative (atol 1e-6): the
  bits are exact, ``log1p`` and ``exp`` may differ by an ulp;
* the plan threads its keys: a key gives the same sample at any batch
  position and in any batch size, another key another sample, and the
  calibration trace's key chain is the reference's.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.plan import BATCHED_OP_IMPLS as J_OPS
from repro_torch.core.engine import Engine as TEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sample as tsample
from repro_torch.models import vae_encoder as tvae

TOL = dict(rtol=2e-6, atol=1e-6)
NARROW = (32, 64, 3)


def _keys(n, seed=0):
    k = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2),
                                             dtype=np.uint32)
    k[0] = 0                        # the all-zero key
    k[1] = 2 ** 32 - 1              # both words at their top
    return k


def _t(keys):
    return torch.from_numpy(keys.astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 16])
def test_split_equals_jax_split(num):
    keys = _keys(300)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(tsample.split(keys, num), want)
    carried, sub = tsample.split_keys(_t(keys))
    np.testing.assert_array_equal(carried.numpy(), want[:, 0])
    np.testing.assert_array_equal(sub.numpy(), want[:, 1])


def test_random_bits_equal_jax_bits():
    keys = _keys(64, seed=1)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (4099,), jnp.uint32))(jnp.asarray(keys)))
    np.testing.assert_array_equal(
        tsample.random_bits(_t(keys), 4099).numpy(), want)


def test_erfinv_is_xlas():
    u = np.concatenate([
        np.linspace(-1, 1, 20001, dtype=np.float32)[1:-1],
        np.float32(1) - np.logspace(-7.2, -1, 500).astype(np.float32),
        np.float32(-1) + np.logspace(-7.2, -1, 500).astype(np.float32)])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = tsample.erfinv_f32(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    edge = tsample.erfinv_f32(torch.tensor([-1.0, 1.0])).numpy()
    assert edge[0] == -np.inf and edge[1] == np.inf


@pytest.mark.parametrize("n", [1, 6, 7, 1000])
def test_normal_matches_jax_random_normal(n):
    keys = _keys(200, seed=n)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (n,)))(
        jnp.asarray(keys)))
    got = tsample.normal_plain(_t(keys), n).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(1,), (6,), (7,), (1000,), (3, 5)])
def test_sample_normal_plain_matches_reference_op(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    b = 9
    mu = rng.standard_normal((b,) + shape).astype(np.float32)
    logvar = rng.standard_normal((b,) + shape).astype(np.float32)
    keys = _keys(b, seed=b + shape[0])
    want = np.asarray(J_OPS["sample_normal"](
        [jnp.asarray(mu), jnp.asarray(logvar)], {}, {}, jnp.asarray(keys)))
    tops.reset_launch_counts()
    got = tops.sample_normal(torch.from_numpy(mu), torch.from_numpy(logvar),
                             _t(keys)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tops.launch_counts()["sample_normal"] == 0   # CPU: plain


def test_sample_normal_refuses_bad_shapes():
    mu = torch.zeros(4, 6)
    for lv, keys in ((torch.zeros(4, 5), torch.zeros(4, 2)),
                     (torch.zeros(4, 6), torch.zeros(3, 2)),
                     (torch.zeros(4, 6), torch.zeros(4, 3))):
        with pytest.raises(ValueError, match="sample_normal"):
            tops.sample_normal(mu, lv, keys)


@pytest.fixture(scope="module")
def vae():
    e = TEngine(tvae.build_graph(NARROW), tvae.init_params(2, NARROW),
                device="cpu")
    rng = np.random.default_rng(2)
    e.calibrate([tvae.synthetic_input(rng, NARROW) for _ in range(2)])
    return e, tvae.synthetic_batch(rng, 4, NARROW)


@pytest.mark.parametrize("backend", ["cpu", "flex", "accel"])
def test_plan_threads_its_seeds(vae, backend):
    """The same key gives the same sample at another batch position and in
    another batch size (bit-exact on accel; the fp32 paths' mu and logvar
    may move by an ulp with the batch size); another key gives another
    sample; the sample is the reference's draw from the second half of
    the key's split."""
    e, batch = vae
    keys = _keys(4, seed=5)
    out = e.run_batch(batch, backend, rngs=keys)
    perm = [2, 0, 3, 1]
    again = e.run_batch({k: v[perm] for k, v in batch.items()}, backend,
                        rngs=keys[perm])
    assert torch.equal(again["sample"], out["sample"][perm])
    one = e.run_batch({k: v[1:2] for k, v in batch.items()}, backend,
                      rngs=keys[1:2])
    if backend == "accel":      # int8 mu/logvar: equal in any batch size
        assert torch.equal(one["sample"][0], out["sample"][1])
    else:                       # fp32 libraries block by batch size
        torch.testing.assert_close(one["sample"][0], out["sample"][1],
                                   **TOL)
    other = keys.copy()
    other[1, 1] ^= 1
    moved = e.run_batch(batch, backend, rngs=other)
    assert torch.equal(moved["mu"], out["mu"])
    assert not torch.equal(moved["sample"][1], out["sample"][1])
    assert torch.equal(moved["sample"][[0, 2, 3]], out["sample"][[0, 2, 3]])
    sub = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys)))[:, 1]
    eps = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (6,)))(
        jnp.asarray(sub)))
    want = out["mu"].numpy() + np.exp(0.5 * out["logvar"].numpy()) * eps
    np.testing.assert_allclose(out["sample"].numpy(), want, **TOL)


def test_default_keys_are_the_references(vae):
    """Without ``rngs`` the engine takes the reference's default, the
    split of key (0, 0) into B keys."""
    e, batch = vae
    want = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.PRNGKey(0), 4)))
    assert torch.equal(e.run_batch(batch, "flex")["sample"],
                       e.run_batch(batch, "flex", rngs=want)["sample"])
