"""Shared helpers for the PyTorch port's tests (``tests/test_torch_*.py``),
plus checks of the helpers themselves.

The port and the JAX reference are held against each other on the same
numpy inputs. Both packages' ``Graph`` classes share one API, so
:func:`cnet_like` builds the CNet-shaped graph in either package from the
same calls; a narrow width keeps the JAX interpret-mode kernels fast.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

from fractions import Fraction

import jax
import numpy as np
import torch

from repro.core.engine import Engine as JEngine
from repro.core.opgraph import Graph as JGraph
from repro.models.common import init_graph_params
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.kernels.epilogue import fma_f32
from repro_torch.models import cnet_plus_scalar as tcnet

NARROW = dict(input_shape=(32, 32, 2), channels=(8, 8, 4), dense=12)


def cnet_like(graph_cls, input_shape=(32, 32, 2), channels=(8, 8, 4),
              dense=12):
    """CNetPlusScalar's builder, written against either package's Graph."""
    g = graph_cls("cnet_plus_scalar")
    x = g.input("image", tuple(input_shape))
    s = g.input("background_flux", (1,))
    for i, c in enumerate(channels):
        x = g.add("conv2d", [x], name=f"conv{i}", kernel=(3, 3), features=c,
                  stride=1, padding="SAME")
        x = g.add("relu", [x], name=f"act{i}")
        x = g.add("maxpool2d", [x], name=f"pool{i}", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    x = g.add("concat", [x, s], name="concat_scalar", axis=0)
    x = g.add("dense", [x], name="fc1", features=dense)
    x = g.add("relu", [x], name="fc1_act")
    y = g.add("dense", [x], name="head", features=1)
    g.mark_output(y)
    return g


def graph_signature(g):
    """Everything a graph's identity is made of, comparable across the two
    packages."""
    nodes = [(n, g.nodes[n].op, g.nodes[n].inputs,
              sorted((k, repr(v)) for k, v in g.nodes[n].attrs.items()),
              g.nodes[n].out_shape, g.nodes[n].param_count,
              g.nodes[n].bias_params, g.nodes[n].macs, g.nodes[n].ops)
             for n in g.order]
    return (g.name, nodes, dict(g.graph_inputs), list(g.outputs), g.n_macs,
            g.n_params, g.n_ops, g.param_bytes())


def to_numpy_params(params):
    return {n: {k: np.asarray(v) for k, v in p.items()}
            for n, p in params.items()}


def twin_engines(n_calib=4, seed=1, widths=NARROW, carry=True, **kw):
    """A calibrated JAX engine and a CPU port engine on the same params
    (drawn on the JAX side) and graph. ``carry`` hands the JAX calibration
    to the port; otherwise the port calibrates itself on the same
    samples. Returns (jax_engine, port_engine, calibration samples)."""
    jg = cnet_like(JGraph, **widths)
    tg = tcnet.build_graph(**widths)
    jp = init_graph_params(jg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    samples = [tcnet.synthetic_input(rng, widths["input_shape"])
               for _ in range(n_calib)]
    je = JEngine(jg, jp, **kw)
    je.calibrate(samples)
    te = TEngine(tg, params_from_numpy(to_numpy_params(jp), "cpu"),
                 device="cpu", **kw)
    if carry:
        te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                                   "cpu"))
    else:
        te.calibrate(samples)
    return je, te, samples


def fault_twins(names, **kw):
    """The reference fault tests' engines and their port twins:
    ``{name: (jax_model, jax_engine, port_engine)}``, params drawn on the
    JAX side (key 0), the reference calibrated on its 2-sample set
    (keys 0 and 1, as numpy) and the calibration carried to the CPU port
    engine, so both plans hold the same int8 weight arenas. ``kw`` goes
    to both engines."""
    from repro.models import SPACE_MODELS as j_models
    from repro_torch.models import SPACE_MODELS as t_models
    out = {}
    for name in names:
        m = j_models[name]
        jp = m.init_params(jax.random.PRNGKey(0))
        je = JEngine(m.build_graph(), jp, **kw)
        je.calibrate([{k: np.asarray(v) for k, v in
                       m.synthetic_input(jax.random.PRNGKey(i)).items()}
                      for i in range(2)])
        te = TEngine(t_models[name].build_graph(),
                     params_from_numpy(to_numpy_params(jp), "cpu"),
                     device="cpu", **kw)
        te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                                   "cpu"))
        out[name] = (m, je, te)
    return out


def storm(side, engines, names, n, upsets=(), stop_at=None, serve=True,
          backends=("accel", "cpu"), ladder=(1, 4), **cfg):
    """One modeled-clock fault storm as the reference fault tests drive
    it, on the reference (``side="jax"``) or the port (``"torch"``): the
    models registered on ``backends`` over ``ladder`` with a warm-up
    request, ``n`` requests each on a bursty trace, a controller over
    ``FaultConfig(**cfg)`` with ``upsets`` given as ``UpsetEvent``
    argument tuples, armed on each model's canary request. Returns
    (scheduler, controller, trace)."""
    from repro.core import faults as jfaults
    from repro.core import radiation as jrad
    from repro.core.scheduler import ContinuousBatchingScheduler as JSched
    from repro.core.scheduler import bursty_arrivals
    from repro.models import synthetic_requests
    from repro_torch.core import faults as tfaults
    from repro_torch.core import radiation as trad
    from repro_torch.core.scheduler import ContinuousBatchingScheduler
    sched_cls, fmod, rmod = {
        "jax": (JSched, jfaults, jrad),
        "torch": (ContinuousBatchingScheduler, tfaults, trad)}[side]
    sched = sched_cls(clock="modeled")
    trace = []
    for mi, name in enumerate(names):
        m, je, te = engines[name]
        reqs = synthetic_requests(m, n, seed=5 + mi)
        sched.register(name, je if side == "jax" else te, backend=backends,
                       ladder=ladder, warmup_sample=reqs[0])
        trace += [(t, name, r) for t, r in
                  zip(bursty_arrivals(n, burst_size=4, gap_s=0.01,
                                      seed=20 + mi), reqs)]
    ctl = fmod.FaultController(fmod.FaultConfig(
        upsets=tuple(rmod.UpsetEvent(*u) for u in upsets), **cfg))
    sched.attach_faults(ctl)
    for mi, name in enumerate(names):
        ctl.arm(sched, name, synthetic_requests(engines[name][0], 1,
                                                seed=5 + mi))
    if serve:
        sched.serve_trace(trace, stop_at=stop_at)
    return sched, ctl, trace


# ---------------------------------------------------------------------------
# checks of the helpers
# ---------------------------------------------------------------------------


def test_fma_f32_is_correctly_rounded():
    """fma_f32 against exact rational arithmetic: the result is a nearest
    float32 to a*b + c, including on operands built to make the float64
    sum land on a float32 rounding boundary."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    # adversarial: c cancels most of a*b, leaving the low product bits
    c[:200] = -(a[:200].astype(np.float64) * b[:200]).astype(np.float32)
    c[200:300] *= np.float32(2.0 ** -30)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for ai, bi, ci, r in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        r = np.float32(r)
        for nb in (np.nextafter(r, np.float32(np.inf)),
                   np.nextafter(r, np.float32(-np.inf))):
            assert abs(exact - Fraction(float(r))) <= \
                abs(exact - Fraction(float(nb)))


def test_cnet_like_matches_port_builder():
    assert (graph_signature(cnet_like(JGraph, **NARROW))
            == graph_signature(tcnet.build_graph(**NARROW)))
