"""QAT in the port against the JAX reference: ``fake_quant`` and its
straight-through gradient (``src/repro/core/quantize.py:145-163``),
``qat_quantize_params`` (``:166-179``), and one self-distillation step of
the QAT example (``examples/qat_finetune.py``) at logistic_net's full
width and at a narrow VAE, with the same weights, sample and keys; plus
the sampler's autograd (the VAE's distillation loss reads ``sample``).

Tolerances: ``fake_quant``, its gradient and the fake-quantized weights
exactly. The reference's QAT step runs compiled, where XLA turns
``max|w| / 127 + 1e-12`` into one fused multiply-add ``fma(max|w|,
float32(1/127), 1e-12)`` (run op by op it divides, then adds; the two
differ by an ulp for some weights): the port computes the compiled form,
as ``quantize_kv`` does.

A distillation step: both forwards (the fp32 teacher's and the
fake-quantized student's outputs) within 1e-5 relative of the
reference's (measured: 1.5e-7 to 3.1e-7; the fp32 libraries sum in other
orders), and so the residual ``student - teacher`` the loss squares
within 1e-5 of the output scale. The loss and the gradients are held to
1e-3 relative (each gradient tensor against its largest magnitude;
measured 5e-5 to 3.9e-4): the residual is ~1e-3 of the outputs, so the
outputs' last-ulp differences reach the loss and the gradients ~1e3
times larger. No summation order short of XLA's own gives
1e-5 there.
"""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import quantize as jq
from repro.core.opgraph import Graph as JGraph
from repro.models import SPACE_MODELS as J_MODELS
from repro.models.common import init_graph_params as j_init
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantize as tq
from repro_torch.examples import qat_finetune as tqat
from repro_torch.kernels import sample as tsample
from repro_torch.models import SPACE_MODELS as T_MODELS
from repro_torch.models import vae_encoder as tvae
from test_torch_space_models import vae_like
from test_torch_support import to_numpy_params

ROOT = Path(__file__).resolve().parents[1]
FORWARD_RTOL = 1e-5
STEP_RTOL = 1e-3
LR = 1e-3


def _reference_example():
    """The reference's QAT example as a module (its ``forward``)."""
    spec = importlib.util.spec_from_file_location(
        "reference_qat_finetune", ROOT / "examples" / "qat_finetune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


@pytest.mark.parametrize("shape,scale", [((64, 8), 0.02), ((4608, 6), 0.01),
                                         ((3, 3, 8, 32), 0.3)])
def test_fake_quant_forward_bit_exact(shape, scale):
    x = _weights(0, shape, scale)
    w2 = x.reshape(-1, shape[-1])
    s = (np.abs(w2).max(0) * np.float32(1 / 127) + np.float32(1e-12))[None]
    # clip range exercised: some entries beyond 127 * scale
    x2 = w2 * np.float32(1.3)
    want = np.asarray(jax.jit(jq.fake_quant)(jnp.asarray(x2),
                                             jnp.asarray(s)))
    eager = np.asarray(jq.fake_quant(jnp.asarray(x2), jnp.asarray(s)))
    got = tq.fake_quant(torch.from_numpy(x2), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eager)


def test_fake_quant_rounds_half_to_even():
    s = np.float32(0.5)
    x = np.asarray([0.25, 0.75, -0.25, 1.25], np.float32)   # /s: .5 ties
    got = tq.fake_quant(torch.from_numpy(x), torch.tensor(s)).numpy()
    want = np.asarray(jq.fake_quant(jnp.asarray(x), jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, 1.0, -0.0, 1.0])


def test_ste_gradient_equals_the_references():
    x = _weights(1, (64, 8), 0.05)
    s = np.full((1, 8), np.float32(0.02 / 127))
    s[0, :4] = np.float32(0.1 / 127)          # half the columns clip
    g = _weights(2, (64, 8))
    jx, js = jax.grad(lambda a, b: jnp.sum(jq.fake_quant(a, b) * g),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    (tq.fake_quant(tx, ts) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jx))
    assert ts.grad is None and not np.asarray(js).any()
    assert 0 < (tx.grad.numpy() == 0).sum() < x.size     # the mask bites


@pytest.mark.parametrize("name", ["logistic_net", "vae_encoder",
                                  "cnet_plus_scalar"])
def test_qat_quantize_params_bit_exact(name):
    m = J_MODELS[name]
    jp = m.init_params(jax.random.PRNGKey(0))
    graph = m.build_graph()
    want = to_numpy_params(jax.jit(
        lambda p: jq.qat_quantize_params(p, graph))(jp))
    got = tq.qat_quantize_params(
        params_from_numpy(to_numpy_params(jp), "cpu"),
        T_MODELS[name].build_graph())
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == sorted(want[n])
        for k in want[n]:
            np.testing.assert_array_equal(got[n][k].numpy(), want[n][k],
                                          err_msg=f"{n}/{k}")


def test_qat_scale_is_the_compiled_references():
    """The compiled reference fuses a multiply by float32(1/127) with the
    add; eager divides, then adds. The port takes the compiled form, and
    weights exist where the two differ."""
    w = _weights(3, (4096, 64), 0.7)
    compiled = np.asarray(jax.jit(
        lambda a: jnp.max(jnp.abs(a), axis=0) / 127.0 + 1e-12)(w))
    eager = np.abs(w).max(0) / np.float32(127.0) + np.float32(1e-12)
    got = tq.qat_scale(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, compiled)
    assert (compiled != eager).any()


def _step_twins(name, input_shape=None):
    """(reference graph, params, port graph, port params, one sample)."""
    if input_shape is None:
        jg, tg = J_MODELS[name].build_graph(), T_MODELS[name].build_graph()
        jp = J_MODELS[name].init_params(jax.random.PRNGKey(0))
        sample = T_MODELS[name].synthetic_input(np.random.default_rng(4))
    else:
        jg = vae_like(JGraph, input_shape)
        tg = tvae.build_graph(input_shape)
        jp = j_init(jg, jax.random.PRNGKey(0))
        sample = tvae.synthetic_input(np.random.default_rng(4), input_shape)
    return jg, jp, tg, params_from_numpy(to_numpy_params(jp), "cpu"), sample


@pytest.mark.parametrize("name,input_shape", [
    ("logistic_net", None), ("vae_encoder", (16, 32, 3))],
    ids=["logistic_net", "vae_narrow"])
def test_distillation_step_matches_the_reference(name, input_shape):
    """One step of the example (teacher = the starting weights, student =
    their fake-quantized copy) against the reference's compiled step,
    with the same weights, sample and keys (the VAE's sample included):
    forwards and residuals within 1e-5, loss and gradients within 1e-3
    (see the module docstring)."""
    ref = _reference_example()
    jg, jp, tg, tp, sample = _step_twins(name, input_shape)
    float_outs = tqat.float_outputs(tg)
    assert float_outs == [o for o in jg.outputs
                          if jg.nodes[o].op not in ("argmax", "greater")]
    rng = jax.random.PRNGKey(0)
    j_teacher = ref.forward(jg, jp, sample, rng)
    j_student = ref.forward(jg, jq.qat_quantize_params(jp, jg), sample, rng)
    with torch.no_grad():
        t_teacher = tqat.forward(tg, tp, sample)
        t_student = tqat.forward(tg, tq.qat_quantize_params(tp, tg), sample)
    for o in float_outs:
        scale = np.abs(np.asarray(j_teacher[o])).max()
        for j, t in ((j_teacher, t_teacher), (j_student, t_student)):
            assert np.abs(t[o].numpy() - np.asarray(j[o])).max() \
                <= FORWARD_RTOL * scale, o
        resid = np.asarray(j_student[o]) - np.asarray(j_teacher[o])
        t_resid = (t_student[o] - t_teacher[o]).numpy()
        assert np.abs(resid).max() > 0
        assert np.abs(t_resid - resid).max() <= FORWARD_RTOL * scale, o

    def loss_fn(p, s):
        rng = jax.random.PRNGKey(0)
        want = ref.forward(jg, jp, s, rng)
        out = ref.forward(jg, jq.qat_quantize_params(p, jg), s, rng)
        return sum(jnp.mean((out[o] - want[o]) ** 2) for o in float_outs)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(jp, sample)
    new, tloss, tgrad = tqat.distill_step(tg, tp, tp, sample, LR)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=STEP_RTOL)
    assert float(tloss) > 0
    jgrad = to_numpy_params(jgrad)
    assert sorted(tgrad) == sorted(jgrad)
    for n in jgrad:
        for k, want in jgrad[n].items():
            got = tgrad[n][k].numpy()
            scale = np.abs(want).max()
            assert scale > 0, f"{n}/{k}: zero reference gradient"
            err = np.abs(got - want).max()
            assert err <= STEP_RTOL * scale, (n, k, err, scale)
            np.testing.assert_allclose(
                new[n][k].numpy(), tp[n][k].numpy() - LR * got, rtol=0,
                atol=0)


def test_vae_gradient_flows_through_the_sample():
    """The VAE's logvar head learns from the sample alone: with only the
    ``sample`` output in the loss (no cancellation), its gradient is
    nonzero and within 1e-5 of the reference's (jax.grad of mu +
    exp(0.5 logvar) eps)."""
    ref = _reference_example()
    jg, jp, tg, tp, sample = _step_twins("vae_encoder", (16, 32, 3))

    def jloss(p):
        return jnp.sum(ref.forward(jg, p, sample,
                                   jax.random.PRNGKey(0))["sample"])

    want = to_numpy_params(jax.grad(jloss)(jp))["logvar"]["w"]
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in p.items()}
              for n, p in tp.items()}
    tqat.forward(tg, leaves, sample)["sample"].sum().backward()
    got = leaves["logvar"]["w"].grad.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()


def test_sampler_autograd_gradcheck():
    """SampleNormal's hand-written backward (the card's path) against
    finite differences, on the CPU in float64."""
    rng = np.random.default_rng(6)
    mu = torch.from_numpy(rng.normal(size=(3, 6))).requires_grad_(True)
    logvar = torch.from_numpy(rng.normal(size=(3, 6)) * 0.5) \
        .requires_grad_(True)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(3, 2),
                                         dtype=np.uint32).astype(np.int64))
    assert torch.autograd.gradcheck(
        lambda a, b: tsample.SampleNormal.apply(a, b, keys), (mu, logvar))


def test_sampler_autograd_equals_the_plain_versions_gradient():
    """On the CPU (float32) the Function's forward is the plain version's
    value and its gradient autograd's through the plain expression, bit
    for bit (the backward multiplies in autograd's order)."""
    rng = np.random.default_rng(7)
    mu0 = rng.normal(size=(4, 6)).astype(np.float32) * 30.0   # |mu| >> std
    lv0 = rng.normal(size=(4, 6)).astype(np.float32)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, size=(4, 2),
                                         dtype=np.uint32).astype(np.int64))
    g = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    grads = []
    for fn in (tsample.sample_normal_plain,
               lambda a, b, k: tsample.SampleNormal.apply(a, b, k)):
        mu = torch.from_numpy(mu0).requires_grad_(True)
        lv = torch.from_numpy(lv0).requires_grad_(True)
        z = fn(mu, lv, keys)
        (z * g).sum().backward()
        grads.append((z.detach(), mu.grad, lv.grad))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=0, atol=0)
    torch.testing.assert_close(grads[1][2], grads[0][2], rtol=0, atol=0)


def _float64_step(name, tg, tp, sample, monkeypatch):
    """The distillation loss and its gradients recomputed in float64 from
    the same state: the teacher's fp32 weights and the student's
    fake-quantized fp32 weights (``qat_quantize_params``, bit-exact to the
    reference's) widened, the forward in float64 (the network's
    ``torch_forward`` twin; the VAE's eps the sampler's draw for the
    sample node's key). The straight-through gradient passes every weight
    (each lies within 127 x its channel's scale), so a weight's gradient
    is its fake-quantized copy's."""
    with torch.no_grad():
        student = tq.qat_quantize_params(tp, tg)
    leaves = {n: {k: v.double().requires_grad_(True) for k, v in p.items()}
              for n, p in student.items()}
    teacher = {n: {k: v.double() for k, v in p.items()}
               for n, p in tp.items()}
    if name == "vae_encoder":
        rng = np.zeros((1, 2), np.uint64)
        for node in tg.order[1:]:            # forward's per-node key chain
            both = tsample.split(rng)
            rng, sub = both[:, 0], both[:, 1]
        eps = tsample.normal_plain(torch.from_numpy(sub.astype(np.int64)),
                                   tvae.LATENT).double()
        monkeypatch.setattr(tvae, "sample_normal",
                            lambda mu, lv: mu + torch.exp(0.5 * lv) * eps)
    forward = T_MODELS[name].torch_forward
    batch = {k: torch.from_numpy(np.asarray(v, np.float64))[None]
             for k, v in sample.items()}
    want = forward(teacher, batch)
    out = forward(leaves, batch)
    loss = sum(torch.mean((out[o] - want[o]) ** 2)
               for o in tqat.float_outputs(tg))
    flat = [v for p in leaves.values() for v in p.values()]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(grads)
    return float(loss), {n: {k: next(it) for k in p}
                         for n, p in leaves.items()}


@pytest.mark.parametrize("name,input_shape", [
    ("logistic_net", None), ("vae_encoder", (16, 32, 3))],
    ids=["logistic_net", "vae_narrow"])
def test_distillation_step_against_a_float64_recomputation(
        name, input_shape, monkeypatch):
    """Both packages' fp32 loss and gradients against the float64
    recomputation of the same step, printed (``-s``) side by side. The
    port's are within 1e-3 relative (the bound the packages are held to
    against each other), except where the reference's own fp32 figure is
    not either: the VAE's conv2 gradient, where fp32 rounding moves an
    activation across a ReLU's kink in both packages alike (8.5% of that
    tensor's largest entry); there the port's may not exceed the
    reference's by more than 10%."""
    ref = _reference_example()
    jg, jp, tg, tp, sample = _step_twins(name, input_shape)
    float_outs = tqat.float_outputs(tg)

    def loss_fn(p, s):
        rng = jax.random.PRNGKey(0)
        want = ref.forward(jg, jp, s, rng)
        out = ref.forward(jg, jq.qat_quantize_params(p, jg), s, rng)
        return sum(jnp.mean((out[o] - want[o]) ** 2) for o in float_outs)

    jloss, jgrad = jax.jit(jax.value_and_grad(loss_fn))(jp, sample)
    jgrad = to_numpy_params(jgrad)
    _, tloss, tgrad = tqat.distill_step(tg, tp, tp, sample, LR)
    loss64, grad64 = _float64_step(name, tg, tp, sample, monkeypatch)
    assert loss64 > 0
    errs = {"reference": [abs(float(jloss) - loss64) / loss64],
            "port": [abs(float(tloss) - loss64) / loss64]}
    for n in grad64:
        for k, g in grad64[n].items():
            g = g.numpy()
            scale = np.abs(g).max()
            if scale == 0:
                continue
            errs["reference"].append(np.abs(jgrad[n][k] - g).max() / scale)
            errs["port"].append(np.abs(tgrad[n][k].numpy() - g).max()
                                / scale)
    print(f"\n{name}: loss and max gradient error against float64: "
          + "; ".join(f"{side} loss {e[0]:.3g}, gradients {max(e[1:]):.3g}"
                      for side, e in errs.items()))
    for mine, theirs in zip(errs["port"], errs["reference"]):
        assert mine <= max(STEP_RTOL, 1.1 * theirs), (mine, theirs)
