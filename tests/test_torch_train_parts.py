"""The training slice's parts against the live JAX reference, on the CPU:

* ``nn/layers.cross_entropy`` (with and without ``valid``) and
  ``nn/moe.aux_load_balance_loss``: within 1e-6 relative;
* ``optim/adamw.py``: five AdamW updates with the cosine schedule and
  clipping on the same numpy grads, fp32 state within 1e-6 of each leaf's
  max (the grad norm's fp32 sum runs in another order, and XLA contracts
  products into fused multiply-adds) and bf16 params identical wherever
  that tolerance cannot move the rounding (else one bf16 ulp apart); the
  schedule and the global norm within 1e-6 relative;
* ``optim/compress.py``: ``int8_compress`` codes and scales bit-exact to
  the reference compiled (the scale one fused multiply-add), and to the
  eager reference wherever its scale (rounded twice) is the same;
  ``ef_compress`` residuals within 1e-7 of the compiled reference; the
  hypothesis counterparts of ``tests/test_properties.py``;
* ``data/pipeline.py``: batches bit-equal for the text and the embedding
  front ends;
* the kernels' refusal of a gradient: ``jax.grad`` through the reference's
  Pallas ``ssd`` and ``flash_attention`` fails, and the port's wrappers
  raise on a ``requires_grad`` CPU tensor; without a gradient they run,
  and the SSM family trains through ``ssd_chunked``.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_arch as j_get_arch, reduced as j_reduced
from repro.configs.base import ShapeSpec as JShape
from repro.data import pipeline as j_data
from repro.kernels import ops as j_ops
from repro.launch import steps as j_steps
from repro.nn.dims import compute_dims as j_dims
from repro.nn.layers import cross_entropy as j_cross_entropy
from repro.nn.moe import aux_load_balance_loss as j_aux
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import tree_from_numpy
from repro_torch.data import pipeline as t_data
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import ssd as t_ssd
from repro_torch.launch import steps as t_steps
from repro_torch.nn import ssm as t_ssm
from repro_torch.nn.dims import compute_dims
from repro_torch.nn.layers import cross_entropy
from repro_torch.nn.moe import aux_load_balance_loss
from repro_torch.nn.params import tree_leaves
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress as t_compress
from test_torch_support import (arch_twin_cfgs, numpy_arch_params,
                                one_torch_thread, train_batches)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    valid = (rng.random((3, 7)) < 0.6) if masked else None
    want = j_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                           jnp.asarray(labels),
                           None if valid is None else jnp.asarray(valid))
    got = cross_entropy(torch.from_numpy(logits).bfloat16(),
                        torch.from_numpy(labels),
                        None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32
    _close(got, want)
    # nothing valid: the sum over a floor of one, zero
    if masked:
        none = cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             torch.zeros((3, 7), dtype=torch.bool))
        assert float(none) == 0.0


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    eidx = logits.argmax(-1).astype(np.int32)
    want = j_aux(jnp.asarray(logits), jnp.asarray(eidx), 8)
    got = aux_load_balance_loss(torch.from_numpy(logits),
                                torch.from_numpy(eidx), 8)
    _close(got, want)


def _grad_trees(rng, n):
    shapes = {"a": {"b": (48,), "w": (64, 48)}, "z": (33, 17)}
    mk = lambda f: {"a": {k: f(s) for k, s in shapes["a"].items()},
                    "z": f(shapes["z"])}
    p0 = mk(lambda s: (rng.standard_normal(s) * 0.02).astype(np.float32))
    grads = [mk(lambda s: (rng.standard_normal(s) * 10 ** rng.uniform(
        -3, 0.5)).astype(np.float32)) for _ in range(n)]
    return p0, grads


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_five_steps_match_reference(dtype):
    """Five updates, lr on the cosine schedule (warmup 2 of 6), clipping at
    1.0: the fp32 state within 1e-6 of each leaf's max and the bf16 params
    identical (``_bf16_identical``), step after step."""
    p0, grads = _grad_trees(np.random.default_rng(0), 5)
    want_dtype = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(want_dtype), p0)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jo = j_adamw.AdamW(lr=j_adamw.cosine_schedule(3e-3, 2, 6))
    to = t_adamw.AdamW(lr=t_adamw.cosine_schedule(3e-3, 2, 6))
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for g in grads:
        jp, js, jn = update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = to.update(tree_from_numpy(g, "cpu"), ts, tp)
        _close(tn, jn)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        for name in ("m", "v", "master"):
            for got, want in zip(tree_leaves(getattr(ts, name)),
                                 jax.tree.leaves(getattr(js, name))):
                want = np.asarray(want)
                assert got.dtype == torch.float32
                assert np.abs(got.numpy() - want).max() <= \
                    RTOL * np.abs(want).max()
        for got, want, w in zip(tree_leaves(tp), jax.tree.leaves(jp),
                                jax.tree.leaves(js.master)):
            if dtype == "bf16":
                assert got.dtype == torch.bfloat16
                _bf16_identical(got, np.asarray(want, np.float32),
                                np.asarray(w))


def _bf16_identical(got, want, master):
    """bf16 params equal the reference's wherever its fp32 master lies
    farther than the fp32 tolerance from a bf16 rounding tie (there the
    rounding cannot flip); elsewhere within one bf16 ulp."""
    d = RTOL * np.abs(master).max()
    lo, hi = (torch.from_numpy(master + e).bfloat16().float().numpy()
              for e in (-d, d))
    sure = lo == hi
    got = got.float().numpy()
    np.testing.assert_array_equal(got[sure], want[sure])
    assert np.all(np.abs(got - want) <= np.abs(hi - lo))
    assert sure.mean() > 0.95


def test_adamw_without_clipping_keeps_the_caller_grads():
    """clip_norm=None: the grads handed in are not touched, and the
    moments equal the reference's bit for bit."""
    p0, (g,) = _grad_trees(np.random.default_rng(1), 1)
    jo = j_adamw.AdamW(lr=1e-3, clip_norm=None)
    to = t_adamw.AdamW(lr=1e-3, clip_norm=None)
    tp = tree_from_numpy(p0, "cpu")
    tg = tree_from_numpy(g, "cpu")
    _, ts, _ = to.update(tg, to.init(tp), tp)
    jp = jax.tree.map(jnp.asarray, p0)
    _, js, _ = jax.jit(jo.update)(jax.tree.map(jnp.asarray, g), jo.init(jp),
                                  jp)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(g)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(tree_leaves(ts.m) + tree_leaves(ts.v),
                         jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_schedule_and_global_norm_match_reference():
    j_lr = jax.jit(j_adamw.cosine_schedule(3e-4, 20, 100))
    t_lr = t_adamw.cosine_schedule(3e-4, 20, 100)
    for s in (0, 1, 7, 19, 20, 21, 55, 99, 100, 140):
        got = t_lr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, j_lr(jnp.int32(s)))
    _, grads = _grad_trees(np.random.default_rng(2), 1)
    _close(t_adamw.global_norm(tree_from_numpy(grads[0], "cpu")),
           j_adamw.global_norm(jax.tree.map(jnp.asarray, grads[0])))


def test_abstract_init_allocates_nothing():
    tp = {"w": torch.empty((4, 3), dtype=torch.bfloat16, device="meta")}
    st_ = t_adamw.AdamW().abstract_init(tp)
    assert st_.step.device.type == "meta" and st_.step.dtype == torch.int32
    assert st_.master["w"].dtype == torch.float32
    assert st_.m["w"].shape == (4, 3)


def _compress_inputs():
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((37, 5)) * 10 ** rng.uniform(-6, 3)
             ).astype(np.float32) for _ in range(120)]


def test_int8_compress_is_bit_exact_to_the_compiled_reference():
    jit = jax.jit(j_compress.int8_compress)
    differ = 0
    for g in _compress_inputs():
        q, s = t_compress.int8_compress(torch.from_numpy(g))
        jq, js = jit(jnp.asarray(g))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        eq, es = j_compress.int8_compress(jnp.asarray(g))
        if float(es) == float(js):
            np.testing.assert_array_equal(q.numpy(), np.asarray(eq))
        else:
            differ += 1          # the eager quotient and sum rounded apart
    assert differ < 40


def test_decompress_tree_and_ef_residuals_match_reference():
    rng = np.random.default_rng(4)
    jef_step = jax.jit(j_compress.ef_compress)
    for seed in range(4):
        g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": (rng.standard_normal(5) * 3).astype(np.float32)}
        jef = j_compress.ErrorFeedback.init(jax.tree.map(jnp.asarray, g))
        tef = t_compress.ErrorFeedback.init(tree_from_numpy(g, "cpu"))
        for _ in range(5):
            jc, jef = jef_step(jax.tree.map(jnp.asarray, g), jef)
            tc, tef = t_compress.ef_compress(tree_from_numpy(g, "cpu"), tef)
            for k in g:
                np.testing.assert_array_equal(tc[k][0].numpy(),
                                              np.asarray(jc[k][0]))
                assert np.abs(tef.residual[k].numpy()
                              - np.asarray(jef.residual[k])).max() <= 1e-7
        back = t_compress.decompress_tree(tc, torch.bfloat16)
        want = j_compress.decompress_tree(jc, jnp.bfloat16)
        for k in g:
            assert back[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(back[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
    comp = t_compress.compress_tree(tree_from_numpy(g, "cpu"))
    assert set(comp) == {"a", "b"} and comp["a"][0].dtype == torch.int8


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 256), st.integers(0, 2 ** 31 - 1))
def test_int8_compress_4x_and_bound(n, seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    q, s = t_compress.int8_compress(g)
    assert q.dtype == torch.int8                  # 4x fewer wire bytes
    back = t_compress.int8_decompress(q, s)
    assert float((g - back).abs().max()) <= float(s) * 0.5 + 1e-6


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 50), st.integers(0, 2 ** 31 - 1))
def test_error_feedback_bounded_residual(steps, seed):
    """EF-SGD invariant: the residual never exceeds one quantization step,
    so compressed updates sum to the true gradient up to O(scale)."""
    rng = np.random.default_rng(seed)
    g_true = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    ef = t_compress.ErrorFeedback.init({"w": g_true})
    total = np.zeros(8, np.float32)
    for _ in range(steps):
        comp, ef = t_compress.ef_compress({"w": g_true}, ef)
        total += t_compress.decompress_tree(comp)["w"].numpy()
    expect = steps * g_true.numpy() - ef.residual["w"].numpy()
    np.testing.assert_allclose(total, expect, atol=1e-4)
    _, s = t_compress.int8_compress(g_true + ef.residual["w"])
    assert float(ef.residual["w"].abs().max()) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-large"])
def test_synthetic_batches_equal_the_reference(arch):
    jc = j_reduced(j_get_arch(arch))
    tc = reduced(get_arch(arch))
    jd, td = j_dims(jc), compute_dims(tc)
    jshape, tshape = JShape("tiny", 24, 3, "train"), ShapeSpec("tiny", 24, 3,
                                                               "train")
    dc, tdc = j_data.DataConfig(seed=2), t_data.DataConfig(seed=2)
    j_it = j_data.data_iterator(jc, jd, jshape, dc, start_step=5)
    t_it = t_data.data_iterator(tc, td, tshape, tdc, start_step=5)
    for _ in range(3):
        want, got = next(j_it), next(t_it)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    over = t_data.synthetic_batch(1, tc, td, tshape, tdc, batch_override=2,
                                  seq_override=9)
    assert over["labels"].shape == (2, 9)
    local = t_data.local_slice(4, tc, td, tshape, tdc)
    want = j_data.local_slice(4, jc, jd, jshape, dc)
    for k in want:
        np.testing.assert_array_equal(local[k], want[k])


# ---------------------------------------------------------------------------
# the kernels refuse a gradient, as jax.grad through a pallas_call fails
# ---------------------------------------------------------------------------


def _ssd_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 2, 4)).astype(np.float32)
    b = rng.standard_normal((1, 16, 8)).astype(np.float32)
    dt = rng.random((1, 16, 2)).astype(np.float32)
    a = -np.ones((2,), np.float32)
    return x, b, b.copy(), dt, a


def test_reference_pallas_kernels_have_no_gradient():
    x, b, c, dt, a = _ssd_inputs()
    j = [jnp.asarray(v) for v in (x, b, c, dt, a)]
    y, _ = j_ops.ssd(*j, chunk=8)                      # the forward runs
    assert y.shape == x.shape
    with pytest.raises(AssertionError):
        jax.grad(lambda x: j_ops.ssd(x, *j[1:], chunk=8)[0].sum())(j[0])
    q = jnp.asarray(np.random.default_rng(6).standard_normal(
        (1, 16, 2, 8)).astype(np.float32))
    assert j_ops.flash_attention(q, q, q, causal=True).shape == q.shape
    with pytest.raises(AssertionError):
        jax.grad(lambda q: j_ops.flash_attention(q, q, q,
                                                 causal=True).sum())(q)


@pytest.mark.parametrize("which", ["ssd", "flash_attention"])
def test_port_kernels_refuse_a_gradient_on_the_cpu_too(which):
    if which == "ssd":
        args = [torch.from_numpy(v) for v in _ssd_inputs()]
        call = lambda *a: t_ssd.ssd(*a, chunk=8)[0]
    else:
        q = torch.randn((1, 16, 2, 8), generator=torch.Generator()
                        .manual_seed(6))
        args = [q, q.clone(), q.clone()]
        call = lambda *a: t_flash.flash_attention(*a, causal=True)
    want = call(*args)                                  # no grad asked
    for i in range(len(args)):
        leaf = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match=f"{which}: the kernel has no "
                           "gradient, as the reference's Pallas kernel"):
            call(*leaf)
        with torch.no_grad():
            torch.testing.assert_close(call(*leaf), want, rtol=0, atol=0)


def test_ssm_family_trains_on_the_cpu_through_ssd_chunked(monkeypatch):
    """On a CPU tensor the mixer takes ``ssd_chunked`` (the kernel's
    wrapper is never reached); its grads match the reference's (the fp32
    cases of tests/test_torch_train_step.py), here the step runs."""
    def kernel(*a, **k):
        raise AssertionError("the ssd kernel's wrapper was called")
    monkeypatch.setattr(t_ssm.ssd_kernel, "ssd", kernel)
    jc, jd, tc, td = arch_twin_cfgs("ssm")
    _, tp = numpy_arch_params(jc, jd, "f32")
    _, tb = train_batches(jc, jd, "f32")
    opt = t_adamw.AdamW(lr=1e-3)
    step = t_steps.make_train_step(tc, td, opt)
    _, m = step(t_steps.TrainState(tp, opt.init(tp)), tb)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_pallas_attention_refuses_a_train_step_in_both_packages():
    """attn_impl="pallas": the reference's jax.grad fails in its flash
    kernel, the port's autograd is refused by its flash wrapper."""
    jc, jd, tc, td = arch_twin_cfgs("dense")
    jp, tp = numpy_arch_params(jc, jd, "f32")
    jb, tb = train_batches(jc, jd, "f32", s=16)
    opts = dict(attn_impl="pallas", remat=False)
    with pytest.raises(AssertionError):
        jax.grad(j_steps.make_loss_fn(jc, jd, j_steps.StepOptions(**opts)))(
            jp, jb)
    opt = t_adamw.AdamW()
    step = t_steps.make_train_step(tc, td, opt, t_steps.StepOptions(**opts))
    with pytest.raises(RuntimeError, match="flash_attention: the kernel has "
                       "no gradient"):
        step(t_steps.TrainState(tp, opt.init(tp)), tb)
