"""The port's engine, planner and PTQ against the JAX reference on a narrow
CNet-shaped graph (32x32x2 image, channels 8/8/4, dense 12).

Parameters are drawn on the JAX side and carried over as numpy arrays
(``repro_torch.convert``); calibration is either carried too or computed
by the port on the same samples.

Tolerances: the int8 accel path is held bit-exact (integer sums, and the
port repeats the reference's roundings); the fp32 cpu/flex paths go
through different convolution libraries, so they agree to 1e-4.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.plan import BATCHED_OP_IMPLS as J_OPS
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.plan import BATCHED_OP_IMPLS as T_OPS
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.opgraph import Graph as TGraph
from repro_torch.models import cnet_plus_scalar as tcnet
from test_torch_support import NARROW, twin_engines

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def carried():
    je, te, _ = twin_engines(carry=True)
    batch = tcnet.synthetic_batch(np.random.default_rng(7), 6,
                                  NARROW["input_shape"])
    return je, te, batch


def test_port_calibration_matches_reference():
    """The port's own calibration: activation absmax within 1e-5, the same
    PTQ demotion set, and bit-identical int8 weights and scales."""
    je, te, _ = twin_engines(carry=False)
    assert set(te._calib) == set(je._calib)
    for name, v in je._calib.items():
        assert te._calib[name] == pytest.approx(v, rel=1e-5), name
    assert te.planned("accel").demoted == je.planned("accel").demoted
    assert set(te._ptq_err) == set(je._ptq_err)
    for name, q in je._quant.items():
        tq = te._quant[name]
        np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(q.w_q))
        np.testing.assert_array_equal(tq.w_scale.numpy(),
                                      np.asarray(q.w_scale))


def test_plan_text_identical(carried):
    je, te, _ = carried
    for fuse in (True, False):
        jp = je.planned("accel") if fuse else _unfused(je)
        tp = te.planned("accel") if fuse else _unfused(te)
        assert tp.as_text() == jp.as_text()
        assert tp.segments == [type(tp.segments[0])(s.backend, s.nodes)
                               for s in jp.segments]
        assert tp.demoted == jp.demoted
        assert sorted(tp.qplans) == sorted(jp.qplans)
    assert te.planned("flex").as_text() == je.planned("flex").as_text()


def _unfused(engine):
    from repro.core.plan import ExecutionPlan as JPlan
    cls = JPlan if engine.__module__.startswith("repro.") else ExecutionPlan
    kw = {} if cls is JPlan else {"device": engine.device}
    return cls(engine.graph, engine.params, "accel", quant=engine._quant,
               act_absmax=engine._calib, ptq_err=engine._ptq_err,
               fuse=False, **kw)


def test_cost_signatures_identical(carried):
    je, te, _ = carried
    for backend in ("accel", "flex", "cpu"):
        for rung in (1, 4, 16):
            tp, jp = te.planned(backend), je.planned(backend)
            view = "cpu" if backend == "cpu" else None
            want = asdict(jp.pipelined_cost_signature(rung, backend=view))
            assert asdict(tp.pipelined_cost_signature(rung,
                                                      backend=view)) == want
            assert asdict(te.compile(backend, rung).cost) == want
            assert ([asdict(s) for s in te.compile(backend, rung).stages]
                    == [asdict(s) for s in jp.stage_costs(rung,
                                                          backend=view)])


def test_accel_bit_exact_with_carried_calibration(carried):
    je, te, batch = carried
    j = np.asarray(je.run_batch(batch, "accel")["head"])
    t = te.run_batch(batch, "accel")["head"].numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("backend", ["flex", "cpu"])
def test_fp32_backends_within_tolerance(carried, backend):
    je, te, batch = carried
    j = np.asarray(je.run_batch(batch, backend)["head"])
    t = te.run_batch(batch, backend)["head"].numpy()
    np.testing.assert_allclose(t, j, **TOL)


def test_accel_rung_invariance_and_fusion_identity(carried):
    """Row i of a batch is bit-identical at every batch size, and the
    fused plan equals the per-node (fuse=False) plan bit for bit."""
    _, te, batch = carried
    full = te.run_batch(batch, "accel")["head"]
    for i in range(len(batch["image"])):
        one = te.run({k: v[i] for k, v in batch.items()}, "accel")["head"]
        assert torch.equal(one, full[i])
    four = te.run_batch({k: v[:4] for k, v in batch.items()}, "accel")
    assert torch.equal(four["head"], full[:4])
    unfused = TEngine(te.graph, te.params, fuse=False, device="cpu")
    unfused.share_calibration(te)
    assert torch.equal(unfused.run_batch(batch, "accel")["head"], full)


def test_compiled_plans_are_cached_and_never_relower(carried):
    _, te, batch = carried
    plan = te.planned("accel")
    c = te.compile("accel", 6)
    n = plan.n_traces
    for _ in range(3):
        te.run_batch(batch, "accel")
    assert te.compile("accel", 6) is c and plan.n_traces == n
    assert c.n_traces == n


def test_weight_arena_is_live_and_repackable(carried):
    """Weights are runtime arguments: corrupting an arena entry changes
    the output, and repack_weights restores it bit-exactly."""
    _, te, batch = carried
    plan = te.planned("accel")
    want = te.run_batch(batch, "accel")["head"]
    arena = plan.weight_arena
    arena["head"] = torch.zeros_like(arena["head"])
    assert not torch.equal(te.run_batch(batch, "accel")["head"], want)
    assert plan.repack_weights(["head"]) == plan.host_weights["head"].nbytes
    assert torch.equal(te.run_batch(batch, "accel")["head"], want)


def test_accel_needs_calibration_and_unported_ops_are_refused(monkeypatch):
    """An op without a batched implementation is refused at plan time.
    Every op of the reference's table is ported now (``sample_normal``
    last), so the refusal is shown with that op taken out of the table."""
    g = tcnet.build_graph(**NARROW)
    e = TEngine(g, tcnet.init_params(0, **NARROW), device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        e.compile("accel", 1)
    assert set(T_OPS) == set(J_OPS)
    g2 = TGraph("vae_tail")
    mu = g2.input("mu", (4,))
    g2.mark_output(g2.add("sample_normal", [mu, mu], name="z"))
    ExecutionPlan(g2, {}, "flex")
    monkeypatch.delitem(T_OPS, "sample_normal")
    with pytest.raises(NotImplementedError, match="sample_normal"):
        ExecutionPlan(g2, {}, "flex")


def test_engine_plan_coverage(carried):
    je, te, _ = carried
    assert te.plan().assignment == je.plan().assignment
    assert te.plan().coverage == je.plan().coverage


# ---------------------------------------------------------------------------
# the batched op table, op by op against the reference (fp32, NHWC)
# ---------------------------------------------------------------------------

_R = np.random.default_rng(3)


def _x(*shape):
    return _R.standard_normal(shape).astype(np.float32)


OP_CASES = [
    ("conv2d", [_x(2, 7, 6, 4)], {"w": _x(3, 3, 4, 5), "b": _x(5)},
     {"stride": 1, "padding": "SAME"}),
    ("conv2d", [_x(2, 7, 6, 4)], {"w": _x(3, 3, 4, 5), "b": _x(5)},
     {"stride": 2, "padding": "SAME"}),
    ("conv2d", [_x(2, 8, 9, 4)], {"w": _x(2, 2, 4, 5), "b": _x(5)},
     {"stride": 2, "padding": "VALID"}),
    ("conv2d", [_x(1, 6, 6, 4)], {"w": _x(3, 3, 2, 6), "b": _x(6)},
     {"padding": "SAME", "groups": 2}),
    ("conv3d", [_x(1, 5, 6, 4, 2)], {"w": _x(3, 3, 3, 2, 3), "b": _x(3)},
     {"stride": 1, "padding": "SAME"}),
    ("maxpool2d", [_x(2, 7, 6, 3)], {}, {"kernel": 2}),
    ("maxpool2d", [_x(2, 7, 7, 3)], {}, {"kernel": 3, "stride": 2}),
    ("avgpool2d", [_x(2, 6, 6, 3)], {}, {"kernel": 2}),
    ("maxpool3d", [_x(1, 4, 5, 6, 2)], {}, {"kernel": 2}),
    ("avgpool3d", [_x(1, 4, 4, 4, 2)], {}, {"kernel": 2}),
    ("dense", [_x(3, 4, 5)], {"w": _x(20, 6), "b": _x(6)}, {}),
    ("dense", [_x(3, 4, 5)], {"w": _x(5, 6)}, {"per_position": True}),
    ("reshape", [_x(2, 12)], {}, {"shape": (3, -1)}),
    ("flatten", [_x(2, 3, 4, 5)], {}, {}),
    ("relu", [_x(3, 7)], {}, {}),
    ("leaky_relu", [_x(3, 7)], {}, {"alpha": 0.2}),
    ("sigmoid", [_x(3, 7)], {}, {}),
    ("tanh", [_x(3, 7)], {}, {}),
    ("softplus", [_x(3, 7)], {}, {}),
    ("exp", [_x(3, 7)], {}, {}),
    ("concat", [_x(2, 3, 4), _x(2, 3, 2)], {}, {"axis": -1}),
    ("concat", [_x(2, 3), _x(2, 1)], {}, {"axis": 0}),
    ("add", [_x(2, 5), _x(2, 5)], {}, {}),
    ("sub", [_x(2, 5), _x(2, 5)], {}, {}),
    ("mul", [_x(2, 5), _x(2, 5)], {}, {}),
    ("greater", [_x(2, 5)], {}, {"threshold": 0.1}),
    ("argmax", [_x(4, 3, 5)], {}, {}),
]


@pytest.mark.parametrize("op,xs,p,a", OP_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_batched_op_matches_reference(op, xs, p, a):
    j = np.asarray(J_OPS[op]([jnp.asarray(x) for x in xs],
                             {k: jnp.asarray(v) for k, v in p.items()}, a,
                             None))
    t = T_OPS[op]([torch.from_numpy(x) for x in xs],
                  {k: torch.from_numpy(v) for k, v in p.items()}, a,
                  None).numpy()
    assert t.shape == j.shape
    if op in ("argmax", "greater", "maxpool2d", "maxpool3d", "flatten",
              "reshape", "concat", "relu"):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_int8_maxpool_is_exact_and_keeps_int8():
    x = _R.integers(-127, 128, (2, 6, 7, 3)).astype(np.int8)
    j = np.asarray(J_OPS["maxpool2d"]([jnp.asarray(x)], {}, {"kernel": 2},
                                      None))
    t = T_OPS["maxpool2d"]([torch.from_numpy(x)], {}, {"kernel": 2},
                           None).numpy()
    assert t.dtype == np.int8
    np.testing.assert_array_equal(t, j)
