"""Per-target ``torch.fx`` -> op-graph translator registry.

Each translator maps one fx node (a ``call_function`` or ``call_method``)
onto zero or more ``NodeSpec``s via the ``TraceState`` passed in, and
returns the node's value: a :class:`View` of an emitted graph node, a
``ConstVal`` or a plain Python value. Registering a new target is one
decorated function:

    @register(torch.special.expit)
    def _expit(state, node, args, kwargs):
        x = the_view(state, node, args[0], "expit input")
        return state.emit_like(node, "sigmoid", [x], perm=x.perm)

Keys are fx targets: torch functions (``torch.conv2d``, ``F.relu``),
``operator`` functions (``operator.add``) and Tensor methods, keyed by the
unbound method (``torch.Tensor.permute``). Translators accept only the
parameterisations the graph ops model; anything else raises
``UnsupportedPrimitiveError`` naming the fx node, never a bare KeyError.

Layout. The graph is channel-last (NHWC / NDHWC, HWIO weights) and has no
transpose op; torch's functional convs and pools are channel-first. A
:class:`View` is a graph tensor seen through a permutation: traced dim
``i`` is graph dim ``perm[i]``. ``permute`` composes permutations and
emits nothing; convs and pools take and give the channel-first view;
element-wise ops keep their operand's view; a reshape, dense, argmax or
output needs the graph's own order (or a permutation that moves only
size-1 dims). ``F.pad`` emits nothing either: its zeros wait on the view
for the conv that consumes them, which classifies pad + conv padding as
SAME (XLA's split: the odd extra row and column at the end) or VALID.

Three peepholes keep traced graphs structurally identical to hand-built
ones:

* ``conv/dense + bias`` folds into the node's bias (sole-consumer
  guarded: the pre-bias tensor must have no other reader). A conv's own
  ``bias`` argument lands there directly.
* a sum pool (``avg_pool(divisor_override=1)``) stages a pending
  ``_sum_poolNd`` spec that the following division by ``k**nd`` rewrites
  to ``avgpoolNd``, the sum-then-divide the batched impl executes.
* dtype conversions (``.float()``, ``.to(dtype)``) are graph no-ops:
  ``greater`` already emits f32 and ``argmax`` int32.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plan import same_pads
from repro_torch.frontend.ir import ConstVal, Ref, UnsupportedPrimitiveError
from repro_torch.frontend.ops import SAMPLE_NORMAL

TRANSLATORS: Dict[Any, Callable] = {}

_REQUIRED = object()


@dataclasses.dataclass(frozen=True)
class View:
    """A graph tensor seen through ``perm`` (traced dim i = graph dim
    perm[i]); ``pads`` holds a pending ``F.pad``, (lo, hi) per traced
    dim, that only a conv may consume."""
    ref: Ref
    perm: Tuple[int, ...]
    pads: Optional[Tuple[Tuple[int, int], ...]] = None


def register(*targets):
    """Decorator: translate fx nodes whose target is any of ``targets``."""
    def deco(fn):
        for t in targets:
            TRANSLATORS[t] = fn
        return fn
    return deco


def fail(node, why: str) -> None:
    raise UnsupportedPrimitiveError(
        f"cannot translate node `{node.format_node()}`: {why}")


def the_view(state, node, val, what: str, pads_ok: bool = False) -> View:
    if not isinstance(val, View):
        fail(node, f"{what} must be a traced tensor, got a trace-time "
                   "constant")
    if val.pads is not None and not pads_ok:
        fail(node, f"{what} carries a pending F.pad: padding is only "
                   "supported directly in front of a conv")
    return val


def identity(rank: int) -> Tuple[int, ...]:
    return tuple(range(rank))


def channel_first(rank: int) -> Tuple[int, ...]:
    """The channel-first view of a channel-last graph tensor."""
    return (0, rank - 1) + tuple(range(1, rank - 1))


def inverse(perm: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(perm))


def neutral(view: View, graph_shape: Sequence[int]) -> bool:
    """Whether the view's memory order is the graph's: the permutation
    moves only size-1 dims."""
    big = [d for d in view.perm if graph_shape[d] != 1]
    return big == sorted(big)


def bind(node, args, kwargs, names: Sequence[Tuple[str, Any]]
         ) -> Dict[str, Any]:
    """Positional + keyword arguments of ``node`` by parameter name."""
    if len(args) > len(names):
        fail(node, f"takes at most {len(names)} arguments")
    out = {}
    for i, (name, default) in enumerate(names):
        if i < len(args):
            out[name] = args[i]
        elif name in kwargs:
            out[name] = kwargs[name]
        elif default is _REQUIRED:
            fail(node, f"missing argument {name!r}")
        else:
            out[name] = default
    extra = set(kwargs) - {n for n, _ in names}
    if extra:
        fail(node, f"unsupported keyword argument(s) {sorted(extra)}")
    return out


def const_scalar(val) -> Optional[float]:
    """A Python float from a size-1 constant, else None."""
    if isinstance(val, (bool, int, float)):
        return float(val)
    if isinstance(val, ConstVal):
        v = torch.as_tensor(val.value)
        if v.numel() == 1:
            return float(v.reshape(()))
    return None


def _ints(node, v, n: int, what: str) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(d) for d in v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        fail(node, f"{what} {v} does not have {n} entries")
    return v


def _iso(node, v, n: int, what: str) -> int:
    vs = _ints(node, v, n, what)
    if len(set(vs)) != 1:
        fail(node, f"anisotropic {what} {vs} are not supported")
    return vs[0]


# ---------------------------------------------------------------------------
# conv / dense
# ---------------------------------------------------------------------------


def _conv(nd: int):
    op = "conv2d" if nd == 2 else "conv3d"

    def t(state, node, args, kwargs):
        a = bind(node, args, kwargs,
                 [("input", _REQUIRED), ("weight", _REQUIRED),
                  ("bias", None), ("stride", 1), ("padding", 0),
                  ("dilation", 1), ("groups", 1)])
        x = the_view(state, node, a["input"], f"{op} input", pads_ok=True)
        w = a["weight"]
        if not isinstance(w, ConstVal):
            fail(node, "conv weights must be a trace-time constant")
        rank = nd + 2
        if x.perm != channel_first(rank):
            fail(node, f"{op} needs its input channel-first (a permute of "
                       f"the channel-last graph tensor), got view {x.perm}")
        if any(d != 1 for d in _ints(node, a["dilation"], nd, "dilation")):
            fail(node, "dilated convolutions are not supported")
        groups = int(a["groups"])
        if op == "conv3d" and groups != 1:
            fail(node, "grouped conv3d is not supported")
        stride = _iso(node, a["stride"], nd, "strides")
        wv = torch.as_tensor(w.value, dtype=torch.float32)
        # OI<spatial> -> <spatial>IO (HWIO / DHWIO), the graph's layout
        w_graph = wv.permute(tuple(range(2, rank)) + (1, 0)).contiguous()
        kernel = tuple(int(k) for k in w_graph.shape[:nd])
        features = int(w_graph.shape[-1])
        gshape = state.spec(x.ref).batched_shape
        spatial = gshape[1:1 + nd]
        pad = a["padding"]
        if isinstance(pad, str):
            if pad not in ("valid", "same") or (pad == "same"
                                                and stride != 1):
                fail(node, f"conv padding {pad!r} is not supported")
            conv_pads = ([(0, 0)] * nd if pad == "valid" else
                         [((k - 1) // 2, k - 1 - (k - 1) // 2)
                          for k in kernel])
        else:
            conv_pads = [(p, p) for p in _ints(node, pad, nd, "padding")]
        pending = x.pads or ((0, 0),) * rank
        if any(pending[i] != (0, 0) for i in (0, 1)):
            fail(node, f"F.pad {pending} pads the batch or channel dim")
        pads = tuple((pending[2 + i][0] + conv_pads[i][0],
                      pending[2 + i][1] + conv_pads[i][1])
                     for i in range(nd))
        if all(p == (0, 0) for p in pads):
            padding = "VALID"
        elif pads == tuple(tuple(same_pads([s], [k], stride, "SAME"))
                           for s, k in zip(spatial, kernel)):
            padding = "SAME"
        else:
            fail(node, f"padding {pads} is neither SAME nor VALID for "
                       f"input {tuple(spatial)}, kernel {kernel}, stride "
                       f"{stride}")
        attrs = {"kernel": kernel, "features": features, "stride": stride,
                 "padding": padding}
        if groups != 1:
            attrs["groups"] = groups
        b = a["bias"]
        if b is not None and not isinstance(b, ConstVal):
            fail(node, "conv bias must be a trace-time constant")
        bias = (torch.zeros(features) if b is None
                else torch.as_tensor(b.value, dtype=torch.float32))
        v = state.emit_like(node, op, [x], attrs,
                            params={"w": w_graph, "b": bias},
                            perm=channel_first(rank))
        state.spec(v.ref).bias_folded = b is not None
        return v
    return t


register(torch.conv2d, F.conv2d)(_conv(2))
register(torch.conv3d, F.conv3d)(_conv(3))


def _dense(state, node, x, w: torch.Tensor, bias=None):
    x = the_view(state, node, x, "dense lhs")
    gshape = state.spec(x.ref).batched_shape
    if len(gshape) != 2:
        fail(node, "dense lhs must be rank-2 (flatten first)")
    if not neutral(x, gshape):
        fail(node, f"dense lhs in view {x.perm} is not in the graph's "
                   "order")
    if w.ndim != 2:
        fail(node, f"dense weights must be rank-2, got {tuple(w.shape)}")
    params = {"w": w.float().contiguous()}
    if bias is not None:
        params["b"] = bias.float()
    v = state.emit_like(node, "dense", [x],
                        {"features": int(w.shape[1]),
                         "bias": bias is not None},
                        params=params, perm=identity(2))
    state.spec(v.ref).bias_folded = bias is not None
    return v


@register(operator.matmul, torch.matmul, torch.mm, torch.Tensor.matmul,
          torch.Tensor.mm)
def _matmul(state, node, args, kwargs):
    x, w = args[0], args[1]
    if not isinstance(w, ConstVal):
        fail(node, "matmul rhs (weights) must be a trace-time constant")
    return _dense(state, node, x, torch.as_tensor(w.value))


@register(F.linear)
def _linear(state, node, args, kwargs):
    a = bind(node, args, kwargs, [("input", _REQUIRED),
                                  ("weight", _REQUIRED), ("bias", None)])
    w, b = a["weight"], a["bias"]
    if not isinstance(w, ConstVal) or not (b is None
                                           or isinstance(b, ConstVal)):
        fail(node, "linear weights and bias must be trace-time constants")
    return _dense(state, node, a["input"], torch.as_tensor(w.value).t(),
                  None if b is None else torch.as_tensor(b.value))


# ---------------------------------------------------------------------------
# elementwise binary (+ bias folding)
# ---------------------------------------------------------------------------


def graph_const(state, node, x: View, val) -> np.ndarray:
    """A constant operand broadcast against ``x``, as the per-sample value
    of a graph ``const`` node in the graph's order."""
    v = torch.as_tensor(val.value if isinstance(val, ConstVal) else val,
                        dtype=torch.float32)
    rank = len(x.perm)
    if v.ndim > rank:
        fail(node, f"rank-{v.ndim} constant does not fit a rank-{rank} "
                   "operand")
    v = v.reshape((1,) * (rank - v.ndim) + tuple(v.shape))
    if v.shape[0] != 1:
        fail(node, "constant broadcast into the batch dimension has no "
                   "graph form")
    return v.permute(inverse(x.perm)).numpy()[0]


def _try_bias_fold(state, node, x: View, cv) -> bool:
    """Fold ``conv/dense(x) + b`` into the producer's bias when ``b`` lies
    on the channel axis and the pre-bias tensor has this add as its only
    reader."""
    spec = state.spec(x.ref)
    if spec.op not in ("conv2d", "conv3d", "dense") or spec.bias_folded:
        return False
    if state.reads_of(x.ref) != 1:
        return False
    if torch.as_tensor(cv.value if isinstance(cv, ConstVal) else cv).ndim \
            == 0:
        return False            # a scalar is a const add, not a bias
    v = graph_const(state, node, x, cv)
    if v.shape[-1] != spec.attrs["features"] or \
            any(d != 1 for d in v.shape[:-1]):
        return False
    spec.params["b"] = torch.from_numpy(v.reshape(-1).copy())
    if spec.op == "dense":
        spec.attrs["bias"] = True
    spec.bias_folded = True
    state.adopt(x.ref, node)
    return True


def _binary(graph_op: str, commutative: bool):
    def t(state, node, args, kwargs):
        a, b = args[0], args[1]
        if kwargs.get("alpha", 1) != 1:
            fail(node, "alpha != 1 is not supported")
        if graph_op == "add":
            for x, cv in ((a, b), (b, a)):
                if isinstance(x, View) and not isinstance(cv, View) \
                        and x.pads is None \
                        and _try_bias_fold(state, node, x, cv):
                    return x
        if commutative and isinstance(b, View) and not isinstance(a, View):
            a, b = b, a
        a = the_view(state, node, a, f"{graph_op} lhs (constant-first "
                                     f"`{graph_op}` has no graph form)")
        out = state.graph_shape(node, a.perm)
        if out != state.spec(a.ref).batched_shape:
            fail(node, f"broadcasting {graph_op} changes the lhs shape "
                       f"{state.spec(a.ref).batched_shape} -> {out}; the "
                       f"graph `{graph_op}` op is shape-preserving")
        if isinstance(b, View):
            b = the_view(state, node, b, f"{graph_op} rhs")
            if b.perm != a.perm:
                fail(node, f"operands in views {a.perm} and {b.perm}")
            bref = b.ref
        else:
            value = graph_const(state, node, a, b)
            bref = state.emit("const", [], {"value": value},
                              (state.batch,) + value.shape)
        return state.emit_like(node, graph_op, [a.ref, bref], perm=a.perm)
    return t


register(operator.add, torch.add, torch.Tensor.add)(
    _binary("add", commutative=True))
register(operator.mul, torch.mul, torch.Tensor.mul)(
    _binary("mul", commutative=True))
register(operator.sub, torch.sub, torch.Tensor.sub)(
    _binary("sub", commutative=False))


@register(operator.truediv, torch.div, torch.Tensor.div)
def _div(state, node, args, kwargs):
    x = the_view(state, node, args[0], "div lhs")
    scalar = const_scalar(args[1])
    spec = state.spec(x.ref)
    # the avgpool peephole: a sum pool staged a pending spec; dividing
    # its sole reader by k**nd is exactly the batched avgpool impl
    if spec.op.startswith("_sum_pool") and scalar is not None \
            and not kwargs:
        nd = int(spec.op[len("_sum_pool")])
        if scalar == float(spec.attrs["kernel"] ** nd) and \
                state.reads_of(x.ref) == 1:
            spec.op = f"avgpool{nd}d"
            state.adopt(x.ref, node)
            return x
    fail(node, "div is only supported as the normalizer of a sum-window "
               "average pool (avg_pool(divisor_override=1) / k**nd)")


@register(operator.gt, torch.gt, torch.Tensor.gt)
def _gt(state, node, args, kwargs):
    x = the_view(state, node, args[0], "gt lhs")
    scalar = const_scalar(args[1])
    if scalar is None:
        fail(node, "gt threshold must be a scalar trace-time constant")
    # the comparison runs in float32, as the reference's weak-typed
    # literal does: the threshold is the float32 value
    return state.emit_like(node, "greater", [x],
                           {"threshold": float(np.float32(scalar))},
                           perm=x.perm)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _unary(graph_op: str):
    def t(state, node, args, kwargs):
        x = the_view(state, node, args[0], f"{graph_op} input")
        return state.emit_like(node, graph_op, [x], perm=x.perm)
    return t


register(F.relu, torch.relu, torch.Tensor.relu)(_unary("relu"))
register(torch.sigmoid, F.sigmoid, torch.Tensor.sigmoid)(_unary("sigmoid"))
register(torch.tanh, F.tanh, torch.Tensor.tanh)(_unary("tanh"))
register(torch.exp, torch.Tensor.exp)(_unary("exp"))


@register(torch.clamp_min, torch.Tensor.clamp_min)
def _clamp_min(state, node, args, kwargs):
    if const_scalar(args[1] if len(args) > 1 else kwargs.get("min")) != 0.0:
        fail(node, "only clamp_min(x, 0), ReLU, is supported")
    return _unary("relu")(state, node, args[:1], {})


@register(torch.Tensor.float, torch.Tensor.to, torch.Tensor.type,
          torch.Tensor.contiguous, torch.Tensor.detach)
def _alias(state, node, args, kwargs):
    # dtype and memory format are execution-plan concerns: the impls
    # cast (`greater` emits f32, `argmax` int32), so these are no-ops
    for v in list(args[1:]) + list(kwargs.values()):
        if isinstance(v, (View, ConstVal)) or isinstance(v, torch.device) \
                or (isinstance(v, str) and v not in ("float", "float32")):
            fail(node, "only dtype conversions and contiguous() are graph "
                       "no-ops")
    return the_view(state, node, args[0], f"{node.target} input")


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


@register(torch.Tensor.permute, torch.permute)
def _permute(state, node, args, kwargs):
    x = the_view(state, node, args[0], "permute input")
    if "dims" in kwargs:
        dims = kwargs["dims"]
    else:
        dims = args[1] if len(args) == 2 and \
            not isinstance(args[1], int) else args[1:]
    rank = len(x.perm)
    dims = tuple(int(d) % rank for d in dims)
    return View(x.ref, tuple(x.perm[d] for d in dims))


@register(F.pad)
def _pad(state, node, args, kwargs):
    a = bind(node, args, kwargs, [("input", _REQUIRED), ("pad", _REQUIRED),
                                  ("mode", "constant"), ("value", None)])
    x = the_view(state, node, a["input"], "pad input")
    if a["mode"] != "constant" or const_scalar(a["value"] or 0.0) != 0.0:
        fail(node, "only zero constant padding is supported")
    pad = [int(p) for p in a["pad"]]
    rank = len(x.perm)
    if len(pad) % 2 or len(pad) // 2 > rank or any(p < 0 for p in pad):
        fail(node, f"pad spec {pad} is not supported")
    pads = [(0, 0)] * rank
    for i in range(len(pad) // 2):
        pads[rank - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if x.perm != channel_first(rank):
        fail(node, "F.pad is only supported on a channel-first view in "
                   "front of a conv")
    return View(x.ref, x.perm, tuple(pads))


def _reshape_to(state, node, x: View, new: Tuple[int, ...]):
    gshape = state.spec(x.ref).batched_shape
    traced = tuple(gshape[d] for d in x.perm)
    if new == traced:
        return x
    per_sample = int(np.prod(traced[1:]))
    if new != (traced[0], per_sample):
        fail(node, f"only batch-preserving flatten reshapes are supported "
                   f"({traced} -> {new})")
    if not neutral(x, gshape):
        fail(node, f"flattening view {x.perm} of graph tensor {gshape} "
                   "would flatten in another order than the graph's "
                   "(permute back to channel-last first)")
    return state.emit_like(node, "flatten", [x], perm=identity(2))


@register(torch.Tensor.reshape, torch.Tensor.view, torch.reshape,
          torch.flatten, torch.Tensor.flatten)
def _reshape(state, node, args, kwargs):
    x = the_view(state, node, args[0], "reshape input")
    return _reshape_to(state, node, x, state.traced_shape(node))


@register(torch.cat, torch.concat, torch.concatenate)
def _concat(state, node, args, kwargs):
    a = bind(node, args, kwargs, [("tensors", _REQUIRED), ("dim", 0)])
    vals = list(a["tensors"])
    views = [v for v in vals if isinstance(v, View)]
    if not views:
        fail(node, "concatenate needs at least one traced operand")
    perm = the_view(state, node, views[0], "concat operand").perm
    dim = int(a["dim"]) % len(perm)
    if perm[dim] == 0:
        fail(node, "concatenating along the batch dimension has no graph "
                   "form")
    refs = []
    for v in vals:
        if isinstance(v, View):
            v = the_view(state, node, v, "concat operand")
            if v.perm != perm:
                fail(node, f"operands in views {perm} and {v.perm}")
            refs.append(v.ref)
        else:
            value = graph_const(state, node, views[0], v)
            refs.append(state.emit("const", [], {"value": value},
                                   (state.batch,) + value.shape))
    return state.emit_like(node, "concat", refs, {"axis": perm[dim] - 1},
                           perm=perm)


# ---------------------------------------------------------------------------
# pooling / reductions
# ---------------------------------------------------------------------------


def _pool(nd: int, kind: str):
    def t(state, node, args, kwargs):
        names = [("input", _REQUIRED), ("kernel_size", _REQUIRED),
                 ("stride", None), ("padding", 0)]
        names += ([("dilation", 1), ("ceil_mode", False),
                   ("return_indices", False)] if kind == "max" else
                  [("ceil_mode", False), ("count_include_pad", True),
                   ("divisor_override", None)])
        a = bind(node, args, kwargs, names)
        x = the_view(state, node, a["input"], "pool input")
        if x.perm != channel_first(nd + 2):
            fail(node, f"pooling needs its input channel-first, got view "
                       f"{x.perm}")
        k = _iso(node, a["kernel_size"], nd, "pool window")
        s = k if a["stride"] in (None, [], ()) else \
            _iso(node, a["stride"], nd, "pool strides")
        if any(p != 0 for p in _ints(node, a["padding"], nd, "padding")):
            fail(node, "padded pooling is not supported (graph pools are "
                       "VALID)")
        if a["ceil_mode"]:
            fail(node, "ceil_mode pooling is not supported")
        if kind == "max":
            if any(d != 1 for d in _ints(node, a["dilation"], nd,
                                         "dilation")):
                fail(node, "dilated pooling is not supported")
            if a["return_indices"]:
                fail(node, "return_indices is not supported")
            op = f"maxpool{nd}d"
        else:
            div = a["divisor_override"]
            if div is None:
                op = f"avgpool{nd}d"
            elif div == 1:
                op = f"_sum_pool{nd}d"     # staged: the next div rewrites
            else:
                fail(node, f"divisor_override={div} is not supported")
        attrs = {"kernel": int(k)}
        if s != k:
            attrs["stride"] = int(s)
        return state.emit_like(node, op, [x], attrs, perm=x.perm)
    return t


register(F.max_pool2d, torch.max_pool2d)(_pool(2, "max"))
register(F.max_pool3d, torch.max_pool3d)(_pool(3, "max"))
register(F.avg_pool2d)(_pool(2, "avg"))
register(F.avg_pool3d)(_pool(3, "avg"))


@register(torch.amax, torch.Tensor.amax)
def _amax(state, node, args, kwargs):
    a = bind(node, args, kwargs, [("input", _REQUIRED), ("dim", ()),
                                  ("keepdim", False)])
    x = the_view(state, node, a["input"], "amax input")
    shape = state.spec(x.ref).batched_shape
    rank = len(shape)
    dims = (a["dim"],) if isinstance(a["dim"], int) else tuple(a["dim"])
    axes = sorted(x.perm[int(d) % rank] for d in dims)
    if rank != 4 or axes != [1, 2] or a["keepdim"]:
        fail(node, "only a global spatial amax over a [batch, h, w, c] "
                   "tensor is supported")
    h, w = shape[1], shape[2]
    if h != w:
        fail(node, f"global amax needs square spatial dims, got {(h, w)}")
    pooled = state.emit("maxpool2d", [x.ref], {"kernel": int(h)},
                        (shape[0], 1, 1, shape[3]))
    return state.emit_like(node, "flatten", [pooled], perm=identity(2))


@register(torch.argmax, torch.Tensor.argmax)
def _argmax(state, node, args, kwargs):
    a = bind(node, args, kwargs, [("input", _REQUIRED), ("dim", None),
                                  ("keepdim", False)])
    x = the_view(state, node, a["input"], "argmax input")
    shape = state.spec(x.ref).batched_shape
    if len(shape) != 2 or a["dim"] is None or int(a["dim"]) % 2 != 1 \
            or a["keepdim"] or not neutral(x, shape):
        fail(node, "only argmax over the feature axis of a [batch, n] "
                   "tensor is supported")
    return state.emit_like(node, "argmax", [x], perm=identity(1))


# ---------------------------------------------------------------------------
# custom front-end ops
# ---------------------------------------------------------------------------


@register(SAMPLE_NORMAL)
def _sample_normal(state, node, args, kwargs):
    mu = the_view(state, node, args[0], "sample_normal mu")
    logvar = the_view(state, node, args[1], "sample_normal logvar")
    if mu.perm != logvar.perm:
        fail(node, f"mu and logvar in views {mu.perm} and {logvar.perm}")
    return state.emit_like(node, "sample_normal", [mu, logvar],
                           perm=mu.perm)
