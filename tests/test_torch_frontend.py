"""The port's ``torch.fx`` front-end against the JAX reference's jaxpr
front-end (``tests/test_frontend.py``): a counterpart of each translator
case, the clear-error contract for unsupported targets and paddings, the
six networks and the cloud-mask demo traced from their PyTorch twins and
held against the reference's traced graphs by position (op, attrs,
per-sample shape, input positions, params after ``convert.py``), the
port's traced graphs against its hand-built ones, and traced vs
hand-built engines bit-identical on ``flex`` and ``accel``.

Node names are not compared (the reference names a node after its
``pjit`` scope, which fx does not have); output names are the user's and
match exactly.

The reference's tracer inlines ``pjit`` calls; the jax on some hosts
names that primitive ``jit``, which its walker does not know. The
``ref_trace`` fixture registers an inliner for ``jit`` through the
reference's own ``register`` for the duration of a test only, so the
reference runs unchanged everywhere else.

Tolerances: graphs, params and int8 results exactly; the demo's fp32
outputs against the reference's ``jax_forward`` within 1e-5 (the fp32
libraries sum in other orders), its flag equal away from the threshold;
its served ``accel`` outputs against the reference engine's within the
reference's CNet-class accel bound (0.02): the grouped convs run fp32 on
flex between int8 layers, where a last-ulp difference can move a code at
a .5 boundary.
"""
import functools
import operator

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro.core.engine import Engine as JEngine
from repro.frontend import demo as jdemo
from repro.frontend import sample_normal as j_sample_normal
from repro.frontend import trace as j_trace
from repro.frontend import translators as j_translators
from repro.models import SPACE_MODELS as J_MODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core import inspector
from repro_torch.core.engine import Engine
from repro_torch.core.opgraph import Graph
from repro_torch.frontend import (TRACE_BATCH, TRANSLATORS,
                                  UnsupportedPrimitiveError, register,
                                  sample_normal, trace)
from repro_torch.frontend import demo
from repro_torch.frontend import ops as fops
from repro_torch.models import SPACE_MODELS, synthetic_requests
from test_torch_support import to_numpy_params

FLEX_TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLE_TOL = dict(rtol=2e-6, atol=1e-6)
DEMO_ACCEL_ATOL = 0.02


def _ops(tm):
    return [tm.graph.nodes[n].op for n in tm.graph.order]


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _flex(tm, x):
    return Engine(tm.graph, tm.params, device="cpu").run_batch(
        x, backend="flex")


# ---------------------------------------------------------------------------
# per-target translator units (tests/test_frontend.py:31-260)
# ---------------------------------------------------------------------------


def test_conv_same_stride_translates_with_folded_bias():
    w = torch.randn(3, 3, 2, 4, generator=torch.Generator().manual_seed(0))
    w = w * 0.1
    b = torch.arange(4, dtype=torch.float32)

    def fn(inp):
        y = F.conv2d(F.pad(_nchw(inp["x"]), [1, 1, 1, 1]),
                     w.permute(3, 2, 0, 1), stride=2) + b[:, None, None]
        return {"y": _nhwc(y)}

    tm = trace(fn, {"x": (9, 9, 2)})
    assert _ops(tm) == ["input", "conv2d"]
    node = tm.graph.nodes["y"]
    assert node.attrs["kernel"] == (3, 3)
    assert node.attrs["features"] == 4
    assert node.attrs["stride"] == 2
    assert node.attrs["padding"] == "SAME"
    assert node.out_shape == (5, 5, 4)
    torch.testing.assert_close(tm.params["y"]["b"], b, rtol=0, atol=0)
    torch.testing.assert_close(tm.params["y"]["w"], w, rtol=0, atol=0)


def test_conv_xla_same_split_at_stride_two_and_own_bias():
    """XLA's SAME at stride 2 on an even size pads only the end; the
    conv's own bias argument lands in the node's bias."""
    w = torch.ones(3, 3, 1, 2)
    b = torch.tensor([0.5, -1.0])

    def fn(inp):
        y = F.conv2d(F.pad(_nchw(inp["x"]), [0, 1, 0, 1]),
                     w.permute(3, 2, 0, 1), b, stride=2)
        return {"y": _nhwc(y)}

    tm = trace(fn, {"x": (8, 8, 1)})
    node = tm.graph.nodes["y"]
    assert node.attrs["padding"] == "SAME" and node.out_shape == (4, 4, 2)
    torch.testing.assert_close(tm.params["y"]["b"], b, rtol=0, atol=0)
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 1)).astype(np.float32)
    torch.testing.assert_close(_flex(tm, {"x": x})["y"],
                               fn({"x": torch.from_numpy(x)})["y"],
                               **FLEX_TOL)


def test_conv_valid_padding_translates():
    w = torch.ones(2, 2, 1, 3)

    def fn(inp):
        return {"y": _nhwc(F.conv2d(_nchw(inp["x"]), w.permute(3, 2, 0, 1)))}

    tm = trace(fn, {"x": (6, 6, 1)})
    assert tm.graph.nodes["y"].attrs["padding"] == "VALID"
    # no bias in the function -> zero bias param (the impl always adds b)
    torch.testing.assert_close(tm.params["y"]["b"], torch.zeros(3),
                               rtol=0, atol=0)


def test_depthwise_conv_translates_to_grouped_conv2d():
    w = torch.randn(3, 3, 1, 6, generator=torch.Generator().manual_seed(1))

    def fn(inp):
        return {"y": _nhwc(F.conv2d(_nchw(inp["x"]), w.permute(3, 2, 0, 1),
                                    padding=1, groups=6))}

    tm = trace(fn, {"x": (8, 8, 6)})
    node = tm.graph.nodes["y"]
    assert node.op == "conv2d" and node.attrs["groups"] == 6
    assert node.attrs["padding"] == "SAME"
    # grouped conv has no int8 kernel -> flex, plain conv2d stays accel
    assert not inspector.accel_supports(node)


def test_conv3d_translates():
    w = torch.ones(2, 2, 2, 1, 3)

    def fn(inp):
        x = inp["x"].permute(0, 4, 1, 2, 3)
        y = F.conv3d(F.pad(x, [0, 1, 0, 1, 0, 1]),
                     w.permute(4, 3, 0, 1, 2))
        return {"y": y.permute(0, 2, 3, 4, 1)}

    tm = trace(fn, {"x": (4, 4, 4, 1)})
    assert tm.graph.nodes["y"].op == "conv3d"
    assert tm.graph.nodes["y"].attrs["kernel"] == (2, 2, 2)
    assert tm.graph.nodes["y"].attrs["padding"] == "SAME"


def test_matmul_with_bias_folds_to_dense():
    w = torch.randn(6, 3, generator=torch.Generator().manual_seed(2))
    b = torch.tensor([1.0, -1.0, 0.5])

    def fn(inp):
        return {"y": inp["x"] @ w + b}

    tm = trace(fn, {"x": (6,)})
    assert _ops(tm) == ["input", "dense"]
    assert tm.graph.nodes["y"].attrs["features"] == 3
    assert tm.graph.nodes["y"].attrs["bias"] is True
    torch.testing.assert_close(tm.params["y"]["b"], b, rtol=0, atol=0)


def test_linear_translates_to_dense_with_transposed_weights():
    w = torch.randn(3, 6, generator=torch.Generator().manual_seed(3))
    b = torch.tensor([1.0, -1.0, 0.5])
    tm = trace(lambda inp: {"y": F.linear(inp["x"], w, b)}, {"x": (6,)})
    assert _ops(tm) == ["input", "dense"]
    torch.testing.assert_close(tm.params["y"]["w"], w.t(), rtol=0, atol=0)
    torch.testing.assert_close(tm.params["y"]["b"], b, rtol=0, atol=0)


def test_dense_without_bias_keeps_bias_false():
    w = torch.ones(4, 2)
    tm = trace(lambda inp: {"y": inp["x"] @ w}, {"x": (4,)})
    assert tm.graph.nodes["y"].attrs["bias"] is False
    assert "b" not in tm.params["y"]


def test_bias_fold_refuses_shared_pre_bias_tensor():
    """If the pre-bias matmul output is read elsewhere, folding the bias
    into the dense node would corrupt that other reader: the fold must
    refuse and emit const+add instead (through a permute too)."""
    w = torch.ones(4, 2)
    b = torch.tensor([1.0, 2.0])

    def fn(inp):
        z = inp["x"] @ w
        return {"y": z + b, "raw": z.permute(0, 1) * 1.0}

    tm = trace(fn, {"x": (4,)})
    assert "const" in _ops(tm) and tm.graph.nodes["y"].op == "add"
    raw = np.ones((2, 4), np.float32)
    out = _flex(tm, {"x": raw})
    ref = fn({"x": torch.from_numpy(raw)})
    for k in ("y", "raw"):
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)


def test_relu_and_unary_activations_translate():
    def fn(inp):
        x = inp["x"]
        return {"r": F.relu(x), "s": torch.sigmoid(x), "t": torch.tanh(x),
                "e": torch.exp(x), "c": torch.clamp_min(x, 0.0)}

    tm = trace(fn, {"x": (5,)})
    got = {tm.graph.nodes[n].op for n in ("r", "s", "t", "e", "c")}
    assert got == {"relu", "sigmoid", "tanh", "exp"}


def test_add_mul_of_two_traced_tensors():
    def fn(inp):
        a = torch.exp(inp["x"])
        b = torch.tanh(inp["x"])
        return {"s": a + b, "p": a * b, "d": a - b}

    tm = trace(fn, {"x": (3,)})
    assert tm.graph.nodes["s"].op == "add"
    assert tm.graph.nodes["p"].op == "mul"
    assert tm.graph.nodes["d"].op == "sub"


def test_scalar_mul_emits_const_node():
    tm = trace(lambda inp: {"y": torch.exp(inp["x"]) * 2.0}, {"x": (3,)})
    ops = _ops(tm)
    assert "const" in ops and "mul" in ops
    x = np.linspace(-1, 1, 6).reshape(2, 3).astype(np.float32)
    torch.testing.assert_close(_flex(tm, {"x": x})["y"],
                               torch.exp(torch.from_numpy(x)) * 2.0,
                               rtol=0, atol=0)


def test_maxpool_translates():
    def fn(inp):
        return {"y": _nhwc(F.max_pool2d(_nchw(inp["x"]), 2))}

    tm = trace(fn, {"x": (6, 6, 2)})
    assert tm.graph.nodes["y"].op == "maxpool2d"
    assert tm.graph.nodes["y"].attrs["kernel"] == 2


def test_avgpool_sum_div_peephole_is_bit_exact():
    def fn(inp):
        s = F.avg_pool2d(_nchw(inp["x"]), 2, divisor_override=1)
        return {"y": _nhwc(s / 4.0)}

    tm = trace(fn, {"x": (6, 6, 2)})
    assert _ops(tm) == ["input", "avgpool2d"]
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 2)) \
        .astype(np.float32)
    torch.testing.assert_close(_flex(tm, {"x": x})["y"],
                               fn({"x": torch.from_numpy(x)})["y"],
                               rtol=0, atol=0)


def test_sum_pool_without_div_raises():
    def fn(inp):
        return {"y": _nhwc(F.avg_pool2d(_nchw(inp["x"]), 2,
                                        divisor_override=1))}

    with pytest.raises(UnsupportedPrimitiveError, match="average pool"):
        trace(fn, {"x": (6, 6, 2)})


def test_global_reduce_max_becomes_pool_plus_flatten():
    tm = trace(lambda inp: {"y": torch.amax(_nchw(inp["x"]), dim=(2, 3))},
               {"x": (4, 4, 3)})
    assert _ops(tm) == ["input", "maxpool2d", "flatten"]
    x = np.random.default_rng(4).normal(size=(2, 4, 4, 3)) \
        .astype(np.float32)
    torch.testing.assert_close(_flex(tm, {"x": x})["y"],
                               torch.from_numpy(x.max(axis=(1, 2))),
                               rtol=0, atol=0)


def test_flatten_reshape_and_identity_reshape():
    def fn(inp):
        x = inp["x"].reshape(inp["x"].shape[0], -1)   # flatten
        return {"y": x.reshape(x.shape)}               # identity: aliased

    tm = trace(fn, {"x": (3, 4, 2)})
    assert _ops(tm) == ["input", "flatten"]


def test_concat_translates_with_per_sample_axis():
    def fn(inp):
        return {"y": torch.cat([inp["a"], inp["b"]], dim=1)}

    tm = trace(fn, {"a": (4,), "b": (2,)})
    assert tm.graph.nodes["y"].op == "concat"
    assert tm.graph.nodes["y"].attrs["axis"] == 0
    assert tm.graph.nodes["y"].out_shape == (6,)


def test_channel_first_concat_maps_to_the_channel_axis():
    def fn(inp):
        y = torch.cat([_nchw(inp["a"]), _nchw(inp["b"])], dim=1)
        return {"y": _nhwc(y)}

    tm = trace(fn, {"a": (4, 4, 2), "b": (4, 4, 3)})
    assert tm.graph.nodes["y"].attrs["axis"] == 2
    assert tm.graph.nodes["y"].out_shape == (4, 4, 5)


def test_gt_threshold_translates_to_greater():
    tm = trace(lambda inp: {"y": (inp["x"] > 0.25).float()}, {"x": (3,)})
    assert tm.graph.nodes["y"].op == "greater"
    assert tm.graph.nodes["y"].attrs["threshold"] == 0.25


def test_argmax_translates():
    tm = trace(lambda inp: {"y": torch.argmax(inp["x"], dim=1)
                            .to(torch.int32)}, {"x": (5,)})
    assert tm.graph.nodes["y"].op == "argmax"
    assert tm.graph.nodes["y"].out_shape == ()


def test_sample_normal_op_translates():
    def fn(inp):
        mu = torch.exp(inp["x"])
        logvar = torch.tanh(inp["x"])
        return {"z": sample_normal(mu, logvar),
                "w": fops.sample_normal(mu, logvar)}

    tm = trace(fn, {"x": (4,)})
    assert tm.graph.nodes["z"].op == "sample_normal"
    assert tm.graph.nodes["w"].op == "sample_normal"


def test_helper_functions_and_modules_inline():
    """The analog of the reference's pjit/custom_jvp inlining: helper
    functions and modules called inside the traced function dissolve
    into their ops."""
    act = nn.ReLU()

    def inner(x):
        return act(x) * 2.0

    tm = trace(lambda inp: {"y": inner(inp["x"])}, {"x": (3,)})
    ops = _ops(tm)
    assert "relu" in ops and "mul" in ops


def test_trace_time_constant_math_is_evaluated_eagerly():
    w = torch.ones(4, 2)
    tm = trace(lambda inp: {"y": inp["x"] @ (w * 3.0)}, {"x": (4,)})
    assert _ops(tm) == ["input", "dense"]
    torch.testing.assert_close(tm.params["y"]["w"], torch.full((4, 2), 3.0),
                               rtol=0, atol=0)


def test_register_extends_the_registry():
    target = torch.special.expit
    assert target not in TRANSLATORS
    try:
        @register(target)
        def _expit(state, node, args, kwargs):
            x = args[0]
            return state.emit_like(node, "sigmoid", [x], perm=x.perm)

        tm = trace(lambda inp: {"y": torch.special.expit(inp["x"])},
                   {"x": (3,)})
        assert tm.graph.nodes["y"].op == "sigmoid"
    finally:
        TRANSLATORS.pop(target, None)


# ---------------------------------------------------------------------------
# unsupported-target contract
# ---------------------------------------------------------------------------


def test_unsupported_target_names_the_node():
    with pytest.raises(UnsupportedPrimitiveError) as exc:
        trace(lambda inp: {"y": torch.sin(inp["x"])}, {"x": (3,)})
    msg = str(exc.value)
    assert "sin" in msg and "register" in msg


def test_unsupported_parameterization_names_the_node():
    w = torch.ones(3, 3, 2, 4)

    def fn(inp):
        return {"y": _nhwc(F.conv2d(_nchw(inp["x"]), w.permute(3, 2, 0, 1),
                                    padding=2, dilation=2))}

    with pytest.raises(UnsupportedPrimitiveError, match="dilated") as exc:
        trace(fn, {"x": (8, 8, 2)})
    assert "conv2d" in str(exc.value)


def test_unsupported_is_never_a_bare_keyerror():
    with pytest.raises(UnsupportedPrimitiveError):
        trace(lambda inp: {"y": torch.cumsum(inp["x"], dim=1)}, {"x": (4,)})


def test_non_dict_output_rejected():
    with pytest.raises(TypeError, match="flat dict"):
        trace(lambda inp: torch.exp(inp["x"]), {"x": (3,)})


@pytest.mark.parametrize("pads,why", [
    ([1, 0, 1, 0], "neither SAME nor VALID"),     # torch's split, reversed
    ([1, 1, 1, 1], "neither SAME nor VALID"),     # symmetric at stride 2
    ([0, 0, 0, 0, 1, 0], "batch or channel")])
def test_padding_that_is_not_the_graphs_raises_naming_the_node(pads, why):
    """Only F.pad + conv(padding=0) splits that equal XLA's SAME or VALID
    translate; torch's symmetric stride-2 padding is another conv."""
    cin = 1 + sum(pads[4:])
    w = torch.ones(3, 3, cin, 2)

    def fn(inp):
        y = F.conv2d(F.pad(_nchw(inp["x"]), pads), w.permute(3, 2, 0, 1),
                     stride=2)
        return {"y": _nhwc(y)}

    with pytest.raises(UnsupportedPrimitiveError, match=why) as exc:
        trace(fn, {"x": (8, 8, 1)})
    assert "%conv2d" in str(exc.value)


def test_pad_outside_a_conv_raises():
    def fn(inp):
        return {"y": _nhwc(torch.relu(F.pad(_nchw(inp["x"]),
                                            [1, 1, 1, 1])))}

    with pytest.raises(UnsupportedPrimitiveError, match="in front of a conv"):
        trace(fn, {"x": (4, 4, 1)})


def test_flatten_in_channel_first_order_raises():
    """A twin that flattens NCHW is another model: the graph has no
    transpose, so the tracer refuses rather than flatten in NHWC order."""
    def fn(inp):
        x = _nchw(inp["x"])
        return {"y": x.reshape(x.shape[0], -1)}

    with pytest.raises(UnsupportedPrimitiveError, match="another order"):
        trace(fn, {"x": (4, 4, 2)})


def test_channel_first_output_raises():
    with pytest.raises(UnsupportedPrimitiveError, match="permute it back"):
        trace(lambda inp: {"y": torch.relu(_nchw(inp["x"]))},
              {"x": (4, 4, 2)})


def test_trace_batch_is_two():
    seen = []

    def fn(inp):
        seen.append(inp["x"].shape[0])
        return {"y": torch.exp(inp["x"])}

    trace(fn, {"x": (3,)})
    assert seen == [TRACE_BATCH] == [2]


# ---------------------------------------------------------------------------
# structural kinds and calibration (tests/test_frontend.py:262-298)
# ---------------------------------------------------------------------------


def test_inspector_excludes_const_nodes_from_coverage():
    g = Graph("structural")
    x = g.input("x", (4,))
    g.add("const", [], name="k", value=np.ones((4,), np.float32))
    g.add("add", [x, "k"], name="y")
    g.mark_output("y")
    rep = inspector.inspect(g)
    assert "const" not in rep.supported + rep.unsupported
    assert "input" not in rep.supported + rep.unsupported
    assert rep.supported == ["add"]
    assert rep.fully_supported


def test_traced_const_graph_calibrates():
    tm = trace(lambda inp: {"y": torch.exp(inp["x"]) * 2.0}, {"x": (3,)})
    eng = Engine(tm.graph, tm.params, device="cpu")
    eng.calibrate([{"x": np.ones((3,), np.float32)}])
    assert eng._calib["y"] > 0


def test_sample_normal_eager_equals_the_references():
    """Outside a trace the op draws eps from key (0, 0) over the whole
    shape, as the reference's eager call does, within 2e-6."""
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(3, 6)).astype(np.float32)
    logvar = rng.normal(size=(3, 6)).astype(np.float32)
    want = np.array(j_sample_normal(jnp.asarray(mu), jnp.asarray(logvar)))
    got = sample_normal(torch.from_numpy(mu), torch.from_numpy(logvar))
    torch.testing.assert_close(got, torch.from_numpy(want), **SAMPLE_TOL)


# ---------------------------------------------------------------------------
# the six networks and the demo, against the reference's traced graphs
# ---------------------------------------------------------------------------


def _inline_jit(state, eqn, invals):
    from repro.frontend.trace import _sub_jaxpr, _walk
    sub, consts = _sub_jaxpr(eqn)
    return _walk(state, sub, consts, invals)


@pytest.fixture
def ref_trace(monkeypatch):
    """The reference's ``trace``, able to inline ``jit`` calls for the
    duration of the test."""
    if "jit" not in j_translators.TRANSLATORS:
        monkeypatch.setitem(j_translators.TRANSLATORS, "jit", _inline_jit)
    return j_trace


def _position_rows(tm):
    g = tm.graph
    pos = {n: i for i, n in enumerate(g.order)}
    rows = []
    for n in g.order:
        node = g.nodes[n]
        attrs = {k: (np.asarray(v).tolist() if k == "value" else v)
                 for k, v in node.attrs.items()}
        params = {k: np.asarray(v) for k, v in tm.params.get(n, {}).items()}
        rows.append((node.op, attrs, node.out_shape,
                     [pos[i] for i in node.inputs], params))
    return rows


def assert_same_by_position(ref, port):
    r, p = _position_rows(ref), _position_rows(port)
    assert len(r) == len(p)
    for i, (a, b) in enumerate(zip(r, p)):
        assert a[:4] == b[:4], (i, a[:4], b[:4])
        assert sorted(a[4]) == sorted(b[4]), (i, sorted(a[4]), sorted(b[4]))
        for k in a[4]:
            np.testing.assert_array_equal(a[4][k], b[4][k],
                                          err_msg=f"node {i} param {k}")
    assert list(ref.out_names) == list(port.out_names)
    assert sorted(ref.graph.outputs) == sorted(port.graph.outputs)
    assert ref.graph.n_params == port.graph.n_params
    assert ref.graph.n_macs == port.graph.n_macs


_PARAMS = {}


def _ref_params(name):
    if name not in _PARAMS:
        jp = J_MODELS[name].init_params(jax.random.PRNGKey(0))
        _PARAMS[name] = to_numpy_params(jp)
    return _PARAMS[name]


def _port_traced(name, params_np):
    m = SPACE_MODELS[name]
    g = m.build_graph()
    return trace(functools.partial(m.torch_forward,
                                   params_from_numpy(params_np, "cpu")),
                 dict(g.graph_inputs), name=name + "_traced")


@pytest.mark.parametrize("name", sorted(SPACE_MODELS))
def test_traced_graph_matches_the_references_by_position(name, ref_trace):
    jm = J_MODELS[name]
    jp = jm.init_params(jax.random.PRNGKey(0))
    ref = ref_trace(functools.partial(jm.jax_forward, jp),
                    dict(jm.build_graph().graph_inputs),
                    name=name + "_traced")
    assert_same_by_position(ref, _port_traced(name, _ref_params(name)))


def test_demo_traced_graph_matches_the_references_by_position(ref_trace):
    jp = jdemo.init_params(jax.random.PRNGKey(42))
    ref = ref_trace(functools.partial(jdemo.jax_forward, jp),
                    {"bands": jdemo.INPUT_SHAPE}, name="cloud_mask_cnn")
    port = demo.build_traced(params=params_from_numpy(to_numpy_params(jp),
                                                      "cpu"))
    assert_same_by_position(ref, port)


@pytest.mark.parametrize("name", sorted(SPACE_MODELS))
def test_traced_graph_structure_matches_hand_built(name):
    m = SPACE_MODELS[name]
    g = m.build_graph()
    tm = _port_traced(name, to_numpy_params(m.init_params(0)))
    assert [g.nodes[n].op for n in g.order] == _ops(tm)
    assert sorted(tm.graph.outputs) == sorted(g.outputs)
    assert tm.graph.n_params == g.n_params
    assert tm.graph.n_macs == g.n_macs


@pytest.mark.parametrize("name", sorted(SPACE_MODELS))
def test_traced_model_bit_exact_on_flex_and_accel(name):
    m = SPACE_MODELS[name]
    g = m.build_graph()
    params = m.init_params(0)
    tm = trace(functools.partial(m.torch_forward, params),
               dict(g.graph_inputs), name=name + "_traced")
    calib = synthetic_requests(m, 2, seed=0)
    reqs = synthetic_requests(m, 2, seed=123)
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    rngs = np.random.default_rng(7).integers(0, 2 ** 32, size=(2, 2),
                                             dtype=np.uint32)
    hand = Engine(g, params, device="cpu")
    traced = Engine(tm.graph, tm.params, device="cpu")
    hand.calibrate(calib)
    traced.calibrate(calib)
    for backend in ("flex", "accel"):
        h = hand.run_batch(batch, backend=backend, rngs=rngs)
        t = traced.run_batch(batch, backend=backend, rngs=rngs)
        assert set(h) == set(t)
        for k in h:
            assert torch.equal(h[k], t[k]), f"{name}/{backend}/{k} diverged"


def test_twins_run_eagerly_as_their_graphs():
    """A twin is also a plain function: run eagerly it gives the hand-built
    graph's flex outputs (the sample from key (0, 0) over the batch)."""
    m = SPACE_MODELS["cnet_plus_scalar"]
    from repro_torch.models import cnet_plus_scalar as tcnet
    narrow = dict(input_shape=(16, 16, 2), channels=(4, 4, 2), dense=5)
    g = tcnet.build_graph(**narrow)
    params = tcnet.init_params(0, **narrow)
    rng = np.random.default_rng(0)
    reqs = [tcnet.synthetic_input(rng, narrow["input_shape"])
            for _ in range(2)]
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    want = Engine(g, params, device="cpu").run_batch(batch, "flex")["head"]
    got = m.torch_forward(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})["head"]
    torch.testing.assert_close(got, want, **FLEX_TOL)


# ---------------------------------------------------------------------------
# the demo: never hand-built, trace -> inspect -> PTQ -> autotune -> serve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_twins():
    """The reference demo's weights (key 42) and tiles (seed 9), and the
    port's traced demo over the same weights."""
    jp = jdemo.init_params(jax.random.PRNGKey(42))
    reqs = jdemo.synthetic_requests(4, seed=9)
    port = demo.build_traced(params=params_from_numpy(to_numpy_params(jp),
                                                      "cpu"))
    return jp, reqs, port


def test_demo_matches_the_reference_demo(demo_twins):
    jp, reqs, port = demo_twins
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    ref = {k: np.array(v) for k, v in jdemo.jax_forward(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    out = Engine(port.graph, port.params, device="cpu").run_batch(batch,
                                                                  "flex")
    torch.testing.assert_close(out["cloud_prob"],
                               torch.from_numpy(ref["cloud_prob"]),
                               **FLEX_TOL)
    off = np.abs(ref["cloud_prob"] - demo.CLOUD_THRESHOLD) > 1e-5
    assert (out["cloud_flag"].numpy()[off] == ref["cloud_flag"][off]).all()


def test_demo_accel_matches_the_reference_engine(demo_twins, ref_trace):
    jp, reqs, port = demo_twins
    ref_tm = ref_trace(functools.partial(jdemo.jax_forward, jp),
                       {"bands": jdemo.INPUT_SHAPE}, name="cloud_mask_cnn")
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    je = JEngine(ref_tm.graph, ref_tm.params)
    te = Engine(port.graph, port.params, device="cpu")
    je.calibrate(reqs[:2])
    te.calibrate(reqs[:2])
    assert te.planned("accel").demoted == je.planned("accel").demoted
    want = {k: np.asarray(v) for k, v in je.run_batch(batch, "accel").items()}
    got = {k: v.numpy() for k, v in te.run_batch(batch, "accel").items()}
    err = np.abs(got["cloud_prob"] - want["cloud_prob"]).max()
    assert err <= DEMO_ACCEL_ATOL, err
    off = np.abs(want["cloud_prob"] - demo.CLOUD_THRESHOLD) > \
        DEMO_ACCEL_ATOL
    assert (got["cloud_flag"][off] == want["cloud_flag"][off]).all()


def test_demo_partial_offload_routing(demo_twins):
    tm = demo_twins[2]
    rep = inspector.inspect(tm.graph)
    assert not rep.fully_supported          # depthwise + sigmoid/greater
    assert rep.mac_coverage > 0.5           # pointwise + dense on accel
    assignment = inspector.assign_backends(tm.graph)
    grouped = [n for n in tm.graph.order
               if tm.graph.nodes[n].attrs.get("groups", 1) != 1]
    assert grouped and all(assignment[n] == "flex" for n in grouped)


def test_demo_serves_end_to_end():
    facts = demo.run_demo(n_requests=8, batch_top=4, verbose=False,
                          device="cpu")
    assert facts["n_completed"] == facts["n_requests"] == 8
    assert 0 <= facts["n_kept"] <= 8
    assert facts["outputs"] == ["cloud_flag", "cloud_prob"]
    assert facts["n_segments"] >= 3         # accel/flex interleaving


def test_demo_weights_and_tiles_have_the_references_shapes():
    ref = to_numpy_params(jdemo.init_params(jax.random.PRNGKey(42)))
    port = demo.init_params(42)
    assert {n: {k: v.shape for k, v in p.items()} for n, p in ref.items()} \
        == {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in port.items()}
    for n in ref:           # He / LeCun scale, drawn by numpy here
        if ref[n]["w"].size >= 144:
            np.testing.assert_allclose(np.std(port[n]["w"].numpy()),
                                       np.std(ref[n]["w"]), rtol=0.2)
    tile = demo.synthetic_requests(1, seed=0)[0]["bands"]
    assert tile.shape == demo.INPUT_SHAPE and tile.dtype == np.float32


def test_registry_targets_include_operator_and_methods():
    assert operator.add in TRANSLATORS and torch.Tensor.permute in TRANSLATORS
    assert fops.SAMPLE_NORMAL in TRANSLATORS
