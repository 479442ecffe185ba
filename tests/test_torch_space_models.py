"""The paper's other five space networks in the port against the JAX
reference: ``multi_esperta``, ``logistic_net``, ``reduced_net`` and
``baseline_net`` at their published widths, and ``vae_encoder`` at a
narrow 32x64x3 input with its published channels.

Parameters are drawn on the JAX side and carried over as numpy arrays
(``repro_torch.convert``); inputs come from the port's numpy generators
and go to both engines. The reference's Pallas kernels run in interpret
mode, as its own tests run them on the CPU.

Tolerances, with their reasons:

* the port's own calibration: activation absmax within 1e-5 relative
  (the fp32 libraries sum in other orders), the same PTQ demotion set as
  the live reference, bit-identical int8 weights and scales;
* ``cpu`` and ``flex`` within 1e-5 (fp32 libraries);
* ``accel``: every int8 layer bit-exact given the same input, and whole
  networks bit-exact where the chain is int8 from the input on
  (``logistic_net``: a max-pool, then the int8 dense; the VAE's ``mu`` and
  ``logvar``). ``reduced_net`` and ``baseline_net`` feed fp32
  ``conv3d`` (oneDNN here, XLA there) to the int8 ``fc1``, where a last-ulp
  difference can move a code at a .5 boundary: they are held to the
  reference's own accel bounds (``tests/test_conformance.py``: 0.02 and
  0.05), with an argmax flip only where the fp32 top-2 margin is within
  twice that;
* ESPERTA's ``prob`` (a sigmoid, fused into the int8 dense when that is
  not demoted) within 1e-6 relative, ``warn`` equal except where
  |prob - threshold| <= 1e-6; ``prob`` also against the paper's
  sequential formulation;
* the VAE's ``sample`` within 2e-6 relative (atol 1e-6) given the same
  raw keys: the threefry bits are exact, ``log1p`` and ``exp`` may
  differ by an ulp.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import numpy as np
import torch

from repro.core.engine import Engine as JEngine
from repro.core.opgraph import Graph as JGraph
from repro.core.plan import _run_quantized as j_run_quantized
from repro.core.quantize import _trace as j_trace
from repro.models import SPACE_MODELS as J_MODELS
from repro.models import esperta as jesperta
from repro.models.common import init_graph_params as j_init
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.plan import _run_quantized as t_run_quantized
from repro_torch.core.quantize import _trace as t_trace
from repro_torch.models import SPACE_MODELS as T_MODELS
from repro_torch.models import esperta as tesperta
from repro_torch.models import mms as tmms
from repro_torch.models import vae_encoder as tvae
from test_torch_support import graph_signature, to_numpy_params

HLS = ("multi_esperta", "logistic_net", "reduced_net", "baseline_net")
BACKENDS = ("cpu", "flex", "accel")
FLEX_TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLE_TOL = dict(rtol=2e-6, atol=1e-6)
ACCEL_ATOL = {"reduced_net": 0.02, "baseline_net": 0.05}
VAE_NARROW = (32, 64, 3)
B = 4


def _keys(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2),
                                                dtype=np.uint32)


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


def vae_like(graph_cls, input_shape):
    """The VAE encoder's builder, written against either package's Graph."""
    g = graph_cls("vae_encoder")
    x = g.input("image", tuple(input_shape))
    for i, c in enumerate(tvae.CHANNELS):
        x = g.add("conv2d", [x], name=f"conv{i}", kernel=(3, 3), features=c,
                  stride=2, padding="SAME")
        x = g.add("relu", [x], name=f"relu{i}")
    x = g.add("flatten", [x], name="flatten")
    mu = g.add("dense", [x], name="mu", features=tvae.LATENT)
    logvar = g.add("dense", [x], name="logvar", features=tvae.LATENT)
    z = g.add("sample_normal", [mu, logvar], name="sample")
    g.mark_output(mu, logvar, z)
    return g


# ---------------------------------------------------------------------------
# graphs, registry, parameters
# ---------------------------------------------------------------------------


def test_registry_holds_all_six_in_the_references_order():
    """(``tests/test_torch_models.py`` holds each entry's graph signature
    and Table I numbers.)"""
    assert list(T_MODELS) == list(J_MODELS)


@pytest.mark.parametrize("name", list(J_MODELS))
def test_graph_summary_identity(name):
    t, j = T_MODELS[name].build_graph(), J_MODELS[name].build_graph()
    assert t.summary() == j.summary()


def test_narrow_builders_match():
    assert graph_signature(tvae.build_graph(VAE_NARROW)) == graph_signature(
        vae_like(JGraph, VAE_NARROW))
    assert graph_signature(tesperta.build_single_graph(3)) == \
        graph_signature(jesperta.build_single_graph(3))


@pytest.mark.parametrize("name", ["vae_encoder", "logistic_net",
                                  "reduced_net", "baseline_net"])
def test_init_params_layout_and_scale(name):
    """The reference's shapes (HWIO conv2d, DHWIO conv3d, [K, N] dense),
    He scale for convs and LeCun for dense, zero biases, deterministic per
    seed."""
    tp = T_MODELS[name].init_params(1)
    jp = jax.eval_shape(J_MODELS[name].init_params, jax.random.PRNGKey(1))
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in tp.items()} == {
        n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jp.items()}
    graph = T_MODELS[name].build_graph()
    for n, p in tp.items():
        op = graph.nodes[n].op
        assert p["w"].dtype == torch.float32
        assert p["w"].ndim == {"conv2d": 4, "conv3d": 5, "dense": 2}[op]
        assert float(p["b"].abs().max()) == 0.0
        fan_in = int(np.prod(p["w"].shape[:-1]))
        gain = 1.0 if op == "dense" else 2.0
        # the smallest layers hold too few draws for a tight std
        rel = 0.1 if p["w"].numel() >= 400 else 0.5
        assert float(p["w"].std()) == pytest.approx((gain / fan_in) ** 0.5,
                                                    rel=rel), n
    again = T_MODELS[name].init_params(1)
    assert all(torch.equal(tp[n]["w"], again[n]["w"]) for n in tp)
    other = T_MODELS[name].init_params(2)
    assert not all(torch.equal(tp[n]["w"], other[n]["w"]) for n in tp)


def test_esperta_params_are_the_published_constants():
    jp = J_MODELS["multi_esperta"].init_params()
    for seed in (None, 0, 5):
        tp = T_MODELS["multi_esperta"].init_params(seed)
        assert set(tp) == set(jp)
        for n in tp:
            for k in ("w", "b"):
                np.testing.assert_array_equal(tp[n][k].numpy(),
                                              np.asarray(jp[n][k]))


@pytest.mark.parametrize("name", ("vae_encoder",) + HLS)
def test_synthetic_inputs(name):
    m = T_MODELS[name]
    a = m.synthetic_batch(np.random.default_rng(0), 3)
    b = m.synthetic_batch(np.random.default_rng(0), 3)
    for k, shape in m.build_graph().graph_inputs.items():
        assert a[k].shape == (3,) + tuple(shape) and a[k].dtype == np.float32
        assert np.isfinite(a[k]).all()
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k][0], a[k][1])
    if name == "multi_esperta":
        f = m.synthetic_batch(np.random.default_rng(1), 200)["features"]
        assert -90 <= f[:, 0].min() and f[:, 0].max() <= 90
        assert 0.5 <= f[:, 1].min() and f[:, 1].max() <= 3.0
        assert 0.3 <= f[:, 2].min() and f[:, 2].max() <= 2.5
    if name in ("logistic_net", "reduced_net", "baseline_net"):
        beam = tmms.synthetic_input(np.random.default_rng(2))["dist"]
        assert beam.argmax() == np.ravel_multi_index((10, 8, 16, 0),
                                                     beam.shape)


# ---------------------------------------------------------------------------
# the four HLS nets at full width, against the live reference
# ---------------------------------------------------------------------------

_TWINS = {}


def twins(name):
    """A reference engine and two CPU port engines on the same params
    (drawn on the JAX side): one that calibrates itself on the same 4
    numpy samples as the reference, and one that adopts the reference's
    calibration (its activation scales are the reference's floats, so
    int8 results can be compared bit for bit). Plus a B=4 batch and each
    side's outputs per backend, on the same keys."""
    if name not in _TWINS:
        jm, tm = J_MODELS[name], T_MODELS[name]
        jp = jm.init_params(jax.random.PRNGKey(1))
        rng = np.random.default_rng(11)
        samples = [tm.synthetic_input(rng) for _ in range(4)]
        je = JEngine(jm.build_graph(), jp)
        je.calibrate(samples)
        tp = params_from_numpy(to_numpy_params(jp), "cpu")
        own = TEngine(tm.build_graph(), tp, device="cpu")
        own.calibrate(samples)
        te = TEngine(tm.build_graph(), tp, device="cpu")
        te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                                   "cpu"))
        batch = tm.synthetic_batch(rng, B)
        keys = _keys(B, 3)
        outs = {be: (_numpy(je.run_batch(batch, be, keys)),
                     {k: v.numpy() for k, v in
                      te.run_batch(batch, be, keys).items()})
                for be in BACKENDS}
        _TWINS[name] = (je, te, own, batch, outs)
    return _TWINS[name]


@pytest.mark.parametrize("name", HLS)
def test_port_calibration_matches_reference(name):
    je, _, own, _, _ = twins(name)
    assert set(own._calib) == set(je._calib)
    for n, v in je._calib.items():
        assert own._calib[n] == pytest.approx(float(v), rel=1e-5), n
    assert own.planned("accel").demoted == je.planned("accel").demoted
    assert sorted(own.planned("accel").qplans) == sorted(
        je.planned("accel").qplans)
    assert set(own._ptq_err) == set(je._ptq_err)
    for n, q in je._quant.items():
        np.testing.assert_array_equal(own._quant[n].w_q.numpy(),
                                      np.asarray(q.w_q))
        np.testing.assert_array_equal(own._quant[n].w_scale.numpy(),
                                      np.asarray(q.w_scale))


@pytest.mark.parametrize("name", HLS)
def test_plan_text_identical(name):
    je, te, _, _, _ = twins(name)
    assert te.planned("accel").as_text() == je.planned("accel").as_text()
    assert te.planned("flex").as_text() == je.planned("flex").as_text()


@pytest.mark.parametrize("name", HLS)
def test_int8_layers_bit_exact_given_the_same_input(name):
    """Each quantized node of the accel plan, fed the same fp32 input on
    both sides, gives the same output bit for bit."""
    je, te, _, _, _ = twins(name)
    jplan, tplan = je.planned("accel"), te.planned("accel")
    rng = np.random.default_rng(5)
    for n, tq in tplan.qplans.items():
        node = tplan.graph.nodes[n]
        shape = tplan.graph.nodes[node.inputs[0]].out_shape
        s = tq.act_scale
        if tq.int8_input:
            x = rng.integers(-127, 128, (B,) + tuple(shape)).astype(np.int8)
        else:
            x = (rng.standard_normal((B,) + tuple(shape)) * 60 * s
                 ).astype(np.float32)
        want = np.asarray(j_run_quantized(jplan.qplans[n], x))
        got = t_run_quantized(tq, torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        if tq.act == "sigmoid":     # the port's sigmoid vs XLA's
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


def _assert_flips_margin_bounded(got, want, logits_ref, atol):
    for i in np.nonzero(got != want)[0]:
        top = np.sort(logits_ref[i].ravel())
        assert float(top[-1] - top[-2]) <= 2 * atol, i


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", HLS)
def test_run_batch_matches_reference(name, backend):
    _, te, _, _, outs = twins(name)
    j, t = outs[backend]
    assert set(t) == set(j)
    plan = te.planned("accel")
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    if name == "multi_esperta":
        for m in range(6):
            p, jp = t[f"prob{m}"], j[f"prob{m}"]
            np.testing.assert_allclose(p, jp, rtol=1e-6, atol=0)
            near = np.abs(jp - tesperta.THRESHOLDS[m]) <= 1e-6
            np.testing.assert_array_equal(t[f"warn{m}"][~near],
                                          j[f"warn{m}"][~near])
        return
    if backend != "accel":
        np.testing.assert_allclose(t["head"], j["head"], **FLEX_TOL)
        np.testing.assert_array_equal(t["region"], j["region"])
    elif name == "logistic_net":
        if "head" in plan.qplans:       # pool -> int8 dense: all exact
            np.testing.assert_array_equal(t["head"], j["head"])
        else:                           # PTQ-demoted: fp32 throughout
            np.testing.assert_allclose(t["head"], j["head"], **FLEX_TOL)
        np.testing.assert_array_equal(t["region"], j["region"])
    else:
        atol = ACCEL_ATOL[name]
        np.testing.assert_allclose(t["head"], j["head"], rtol=0, atol=atol)
        _assert_flips_margin_bounded(t["region"], j["region"],
                                     outs["cpu"][0]["head"], atol)


def test_esperta_matches_the_sequential_original():
    """multi-ESPERTA's prob per sample against the paper's six sequential
    models (float64 logit), on every backend of the port."""
    _, _, _, batch, outs = twins("multi_esperta")
    for i in range(B):
        sample = {"features": batch["features"][i]}
        seq = tesperta.sequential_reference(sample)
        jseq = jesperta.sequential_reference(sample)
        for k in seq:
            np.testing.assert_array_equal(seq[k], jseq[k])
        for be in BACKENDS:
            t = outs[be][1]
            for m in range(6):
                np.testing.assert_allclose(t[f"prob{m}"][i],
                                           seq[f"prob{m}"], rtol=1e-6)


# ---------------------------------------------------------------------------
# the VAE encoder, narrow, with its sampling tail
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae():
    jg, tg = vae_like(JGraph, VAE_NARROW), tvae.build_graph(VAE_NARROW)
    jp = j_init(jg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    samples = [tvae.synthetic_input(rng, VAE_NARROW) for _ in range(4)]
    je = JEngine(jg, jp)
    je.calibrate(samples)
    tp = params_from_numpy(to_numpy_params(jp), "cpu")
    own = TEngine(tg, tp, device="cpu")
    own.calibrate(samples)
    te = TEngine(tg, tp, device="cpu")
    te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                               "cpu"))
    batch = tvae.synthetic_batch(rng, B, VAE_NARROW)
    return je, te, own, samples, batch


def test_vae_own_calibration_matches_reference(vae):
    je, _, own, _, _ = vae
    for n, v in je._calib.items():
        if n == "sample":       # the trace's draw: held below
            continue
        assert own._calib[n] == pytest.approx(float(v), rel=1e-5), n
    assert own.planned("accel").demoted == je.planned("accel").demoted
    for n, q in je._quant.items():
        np.testing.assert_array_equal(own._quant[n].w_q.numpy(),
                                      np.asarray(q.w_q))


def test_vae_calibration_trace_draws_the_references_sample(vae):
    """The trace's per-node key chain from key (0, 0) is the reference's,
    so its ``sample`` is the reference's draw."""
    je, te, _, samples, _ = vae
    want = np.asarray(j_trace(je, samples[0])["sample"])
    got = t_trace(te, samples[0])["sample"].numpy()
    np.testing.assert_allclose(got, want, **SAMPLE_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vae_matches_reference(vae, backend):
    je, te, _, _, batch = vae
    keys = _keys(B, 9)
    j = _numpy(je.run_batch(batch, backend, keys))
    t = {k: v.numpy() for k, v in te.run_batch(batch, backend,
                                                keys).items()}
    if backend == "accel":
        assert sorted(te.planned("accel").qplans) == sorted(
            je.planned("accel").qplans)
        np.testing.assert_array_equal(t["mu"], j["mu"])
        np.testing.assert_array_equal(t["logvar"], j["logvar"])
        np.testing.assert_allclose(t["sample"], j["sample"], **SAMPLE_TOL)
    else:
        for k in ("mu", "logvar", "sample"):
            np.testing.assert_allclose(t[k], j[k], **FLEX_TOL)
