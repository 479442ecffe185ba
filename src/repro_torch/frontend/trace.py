"""``torch.fx`` front-end: trace a plain batched PyTorch function into the
op graph.

    traced = trace(fn, {"image": (128, 256, 3)}, name="my_net")
    engine = Engine(traced.graph, traced.params, device="cpu")

``fn`` takes one dict of **batched** tensors and returns a flat dict of
batched tensors; the returned keys become the graph's output node names
(results are keyed by output name, so the user, not the tracer, owns
those names). Graph inputs and outputs are channel-last, as the
hand-built graphs are. Tracing happens at a fixed batch of 2, which
tells the batch dim from size-1 tensor dims; per-sample graph shapes
are the traced shapes minus the leading dim.

The walk is a straightforward abstract interpretation of the
``torch.fx`` graph of ``fn`` (traced on meta tensors, so shapes are
concrete Python values inside ``fn``): captured tensors (``get_attr``) and
literals become ``ConstVal``s, nodes whose inputs are all constants are
evaluated eagerly (weight permutes included, so weights reach the graph
already in HWIO), and everything else dispatches through the translator
registry (translators.py). Shapes come from ``ShapeProp`` on zero inputs.
Node specs are staged so peepholes can rewrite them (bias folding, sum
pool -> avgpool); the ``Graph`` is built at the end, where every node's
inferred shape is cross-checked against the traced one: a translation
bug dies there, named, instead of surfacing as wrong numerics downstream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.fx
from torch.fx.experimental import meta_tracer
from torch.fx.passes.shape_prop import ShapeProp

from repro_torch.core.opgraph import Graph
from repro_torch.frontend.ir import ConstVal, NodeSpec, Ref, \
    UnsupportedPrimitiveError
from repro_torch.frontend.translators import TRANSLATORS, View, identity, \
    inverse

# fixed trace batch: >1 so the batch dim can't be mistaken for a size-1
# tensor dim when reshapes are classified
TRACE_BATCH = 2

# fx users that read a tensor's metadata, not its values
_META_READS = {"size", "dim"}
# fx users that alias their operand (same graph tensor, another view)
_ALIAS_METHODS = {"permute", "float", "to", "type", "contiguous", "detach"}
_RESHAPES = {"reshape", "view", "flatten"}


@dataclasses.dataclass
class TracedModel:
    graph: Graph
    params: Dict[str, Dict[str, torch.Tensor]]
    out_names: Tuple[str, ...]


@contextlib.contextmanager
def _meta_constants():
    """While tracing, captured tensors join the meta computation of the
    shapes as meta tensors (the meta tracer otherwise leaves every result
    downstream of a CPU constant without a concrete shape)."""
    plain = meta_tracer.proxys_to_metas

    def to_meta(v):
        if isinstance(v, torch.Tensor) and not isinstance(v, torch.fx.Proxy):
            return v.to("meta")
        return plain(v)

    meta_tracer.proxys_to_metas = to_meta
    try:
        with warnings.catch_warnings():
            # a node whose meta cannot be computed keeps a symbolic shape;
            # ShapeProp below gives every node its shape either way
            warnings.filterwarnings("ignore", "Could not compute metadata")
            yield
    finally:
        meta_tracer.proxys_to_metas = plain


class _Tracer(meta_tracer.MetaTracer):
    """The meta tracer, stepping into every module's forward: a module
    called inside the traced function dissolves into its ops."""

    def is_leaf_module(self, m, module_qualified_name) -> bool:
        return False


def _target_key(node: torch.fx.Node):
    if node.op == "call_method":
        return getattr(torch.Tensor, node.target, node.target)
    return node.target


def _traced(node: torch.fx.Node) -> Optional[Tuple[int, ...]]:
    meta = node.meta.get("tensor_meta")
    return tuple(meta.shape) if hasattr(meta, "shape") else None


def _is_alias(user: torch.fx.Node, of: torch.fx.Node) -> bool:
    if not user.args or user.args[0] is not of:
        return False
    key = _target_key(user)
    if user.op == "call_method" and user.target in _ALIAS_METHODS \
            or key is torch.permute:
        return True
    reshape = (user.op == "call_method" and user.target in _RESHAPES) or \
        key in (torch.reshape, torch.flatten)
    return reshape and _traced(user) == _traced(of)


def _reads(node: torch.fx.Node) -> int:
    """The readers of ``node``'s tensor, looking through aliases."""
    n = 0
    for user in node.users:
        if user.op == "call_function" and user.target is getattr or \
                user.op == "call_method" and user.target in _META_READS:
            continue
        n += _reads(user) if _is_alias(user, node) else 1
    return n


class TraceState:
    """Mutable walk state: staged node specs and the fx node each graph
    tensor currently comes from (the sole-consumer guard of the
    peepholes reads its users)."""

    def __init__(self, batch: int):
        self.batch = batch
        self.specs: List[NodeSpec] = []
        self._origin: Dict[int, torch.fx.Node] = {}

    # -- used by translators ------------------------------------------------

    def emit(self, op: str, inputs: List[Ref], attrs: Dict[str, Any],
             batched_shape: Tuple[int, ...],
             params: Optional[Dict[str, Any]] = None) -> Ref:
        spec = NodeSpec(len(self.specs), op, [r.sid for r in inputs],
                        dict(attrs), tuple(batched_shape),
                        params=dict(params or {}))
        self.specs.append(spec)
        return Ref(spec.sid)

    def emit_like(self, node: torch.fx.Node, op: str, inputs: List[Any],
                  attrs: Optional[Dict[str, Any]] = None,
                  params: Optional[Dict[str, Any]] = None, *,
                  perm: Tuple[int, ...]) -> View:
        """Emit ``op`` for fx ``node``, whose traced value is the result
        seen through ``perm``."""
        refs = [v.ref if isinstance(v, View) else v for v in inputs]
        ref = self.emit(op, refs, attrs or {}, self.graph_shape(node, perm),
                        params)
        self._origin[ref.sid] = node
        return View(ref, perm)

    def spec(self, ref: Ref) -> NodeSpec:
        return self.specs[ref.sid]

    def traced_shape(self, node: torch.fx.Node) -> Tuple[int, ...]:
        shape = _traced(node)
        if shape is None:
            raise UnsupportedPrimitiveError(
                f"node `{node.format_node()}` produced no tensor")
        return shape

    def graph_shape(self, node: torch.fx.Node,
                    perm: Tuple[int, ...]) -> Tuple[int, ...]:
        traced = self.traced_shape(node)
        if len(traced) != len(perm):
            raise UnsupportedPrimitiveError(
                f"node `{node.format_node()}`: rank {len(traced)} result "
                f"seen through view {perm}")
        return tuple(traced[i] for i in inverse(perm))

    def reads_of(self, ref: Ref) -> int:
        """How many fx nodes read the tensor ``ref`` currently stands for
        (through any permute or no-op conversion). Unknown -> 2, so
        peepholes that need a sole consumer refuse to fire."""
        node = self._origin.get(ref.sid)
        return 2 if node is None else _reads(node)

    def adopt(self, ref: Ref, node: torch.fx.Node) -> None:
        """``ref`` now stands for fx ``node``'s value (a peephole folded
        ``node`` into it)."""
        self._origin[ref.sid] = node


def _has_view(v) -> bool:
    if isinstance(v, View):
        return True
    if isinstance(v, (list, tuple)):
        return any(_has_view(x) for x in v)
    if isinstance(v, dict):
        return any(_has_view(x) for x in v.values())
    return False


def _unwrap(v):
    if isinstance(v, ConstVal):
        return v.value
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    return ConstVal(v) if isinstance(v, torch.Tensor) else v


def _walk(state: TraceState, gm: torch.fx.GraphModule,
          inputs: Dict[str, View]) -> Any:
    env: Dict[torch.fx.Node, Any] = {}
    for node in gm.graph.nodes:
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        if node.op == "placeholder":
            env[node] = inputs
        elif node.op == "get_attr":
            value = gm
            for part in node.target.split("."):
                value = getattr(value, part)
            env[node] = _wrap(value.detach().cpu())
        elif node.op == "output":
            return args[0]
        elif node.op == "call_function" and node.target is getattr \
                and isinstance(args[0], View):
            if args[1] != "shape":
                raise UnsupportedPrimitiveError(
                    f"node `{node.format_node()}` reads attribute "
                    f"{args[1]!r} of a traced tensor")
            env[node] = torch.Size(state.traced_shape(node.args[0]))
        elif node.op == "call_method" and node.target == "size" \
                and isinstance(args[0], View):
            size = torch.Size(state.traced_shape(node.args[0]))
            env[node] = size if len(args) == 1 else size[args[1]]
        elif node.op == "call_function" and node.target is \
                operator.getitem and isinstance(args[0], dict):
            if args[1] not in args[0]:
                raise KeyError(f"traced function reads input {args[1]!r}, "
                               f"not among {sorted(args[0])}")
            env[node] = args[0][args[1]]
        elif not _has_view(args) and not _has_view(kwargs):
            # pure trace-time computation: evaluate eagerly
            a, kw = _unwrap(args), _unwrap(kwargs)
            if node.op == "call_method":
                res = getattr(a[0], node.target)(*a[1:], **kw)
            elif node.op == "call_function":
                res = node.target(*a, **kw)
            else:
                raise UnsupportedPrimitiveError(
                    f"node `{node.format_node()}`: {node.op} is not "
                    "supported (trace a function, not a module tree)")
            env[node] = _wrap(res)
        else:
            key = _target_key(node)
            fn = TRANSLATORS.get(key) if node.op in (
                "call_function", "call_method") else None
            if fn is None:
                raise UnsupportedPrimitiveError(
                    f"no translator registered for `{node.format_node()}` "
                    f"(target {key!r}); add one with "
                    "repro_torch.frontend.translators.register")
            env[node] = fn(state, node, args, kwargs)
    raise AssertionError("fx graph without an output node")


def _finalize(state: TraceState, name: str, input_names: List[str],
              shapes: Dict[str, Tuple[int, ...]], outvals: Dict[str, Any]
              ) -> TracedModel:
    out_names = sorted(outvals)
    out_by_sid: Dict[int, str] = {}
    for oname in out_names:
        val = outvals[oname]
        if not isinstance(val, View):
            raise UnsupportedPrimitiveError(
                f"output {oname!r} is a trace-time constant, not a traced "
                "tensor")
        if val.pads is not None or \
                val.perm != identity(len(val.perm)):
            raise UnsupportedPrimitiveError(
                f"output {oname!r} is returned in view {val.perm} of the "
                "channel-last graph tensor (permute it back)")
        if val.ref.sid in out_by_sid:
            raise ValueError(
                f"outputs {out_by_sid[val.ref.sid]!r} and {oname!r} are "
                "the same traced tensor; each output needs its own node")
        spec = state.specs[val.ref.sid]
        if spec.op == "input" and spec.hint != oname:
            raise ValueError(
                f"output {oname!r} is the untouched input {spec.hint!r}")
        out_by_sid[val.ref.sid] = oname

    g = Graph(name)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    used = set(input_names) | set(out_names)
    for k in input_names:
        g.input(k, shapes[k])
    for spec in state.specs:
        if spec.op == "input":
            spec.name = spec.hint
            continue
        if spec.op.startswith("_sum_pool"):
            raise UnsupportedPrimitiveError(
                "a sum pool (avg_pool with divisor_override=1) without a "
                "trailing division by the window size has no graph form "
                "(expected an average pool)")
        node_name = out_by_sid.get(spec.sid)
        if node_name is None:
            i = len(g.order)
            node_name = f"{spec.op}_{i}"
            while node_name in used or node_name in g.nodes:
                i += 1
                node_name = f"{spec.op}_{i}"
        used.add(node_name)
        in_names = [state.specs[s].name for s in spec.inputs]
        g.add(spec.op, in_names, name=node_name, **spec.attrs)
        spec.name = node_name
        expect = tuple(spec.batched_shape[1:])
        if g.nodes[node_name].out_shape != expect:
            raise AssertionError(
                f"tracer bug at node {node_name!r} ({spec.op}): graph "
                f"inferred {g.nodes[node_name].out_shape} but the fx graph "
                f"traced per-sample {expect}")
        if spec.params:
            params[node_name] = {
                k: torch.as_tensor(v, dtype=torch.float32).clone()
                for k, v in spec.params.items()}
    g.mark_output(*out_names)
    return TracedModel(g, params, tuple(out_names))


def trace(fn: Callable, example_inputs: Dict[str, Any], *,
          name: str = "traced") -> TracedModel:
    """Trace ``fn`` (dict of batched tensors -> flat dict of batched
    tensors) into a ``TracedModel``. ``example_inputs`` maps input names
    to per-sample shapes (tuples) or per-sample example arrays."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for k, v in example_inputs.items():
        if isinstance(v, (tuple, list)) and \
                all(isinstance(d, (int, np.integer)) for d in v):
            shapes[k] = tuple(int(d) for d in v)
        else:
            shapes[k] = tuple(np.shape(v))

    def root(batch):
        return fn(batch)

    # meta tensors make shapes concrete while tracing (``x.shape[0]`` is
    # the trace batch, as in a jaxpr), so functions may compute padding
    # or reshape targets from them
    with _meta_constants():
        tracer = _Tracer()
        graph = tracer.trace(root, meta_args={"batch": {
            k: torch.zeros((TRACE_BATCH,) + s, device="meta")
            for k, s in shapes.items()}})
    gm = torch.fx.GraphModule(tracer.root, graph, name)
    zeros = {k: torch.zeros((TRACE_BATCH,) + s) for k, s in shapes.items()}
    with torch.no_grad():
        out = ShapeProp(gm).propagate(zeros)
    if not isinstance(out, dict) or not all(
            isinstance(v, torch.Tensor) for v in out.values()):
        raise TypeError("traced function must return a flat dict of named "
                        f"output tensors, got {type(out).__name__}")

    state = TraceState(TRACE_BATCH)
    input_names = sorted(shapes)
    inputs = {}
    for k in input_names:
        spec = NodeSpec(len(state.specs), "input", [], {},
                        (TRACE_BATCH,) + shapes[k], hint=k)
        state.specs.append(spec)
        inputs[k] = View(Ref(spec.sid), identity(len(shapes[k]) + 1))
    with torch.no_grad():
        outvals = _walk(state, gm, inputs)
    return _finalize(state, name, input_names, shapes, outvals)
