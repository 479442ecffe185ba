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
