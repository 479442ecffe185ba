"""Layer-graph IR for the space use-case networks.

The paper's workflow is graph-centric: Netron to visualize, the Vitis AI
*inspector* to check operator support, ONNX2C to translate for HLS. This
module is the equivalent substrate: a small typed op graph with shape
inference and MAC/parameter accounting (Table I), which the inspector
partitions and the engine executes on either backend.

Ops cover everything the four use cases need: 2-D and 3-D conv/pool,
dense, activations (relu / leaky_relu / sigmoid / softplus / tanh),
flatten / concat / add / mul / exp, comparator (`greater`) and gaussian
sampling — the last two being exactly the ops the paper calls out as
DPU-unsupported.

Two structural kinds support the pass pipeline (core/passes.py,
DESIGN.md §10):

* ``const`` — a compile-time value (``attrs["value"]``), produced by
  constant folding; carries no runtime cost.
* ``fused`` — a compute node (``attrs["base_op"]`` in conv2d/dense) with
  an element-wise epilogue (``attrs["epilogue"]`` in relu/sigmoid) and an
  optional int8 requantize step folded in. Parameters live under the
  original producer's name (``attrs["param_of"]``); shape inference
  delegates to the base op (epilogues are shape-preserving).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Shape = Tuple[int, ...]

# fused-node epilogue ops must be shape-preserving element-wise ops
FUSABLE_EPILOGUES = ("relu", "sigmoid")

# ops that consume the per-sample RNG stream: their EXECUTION ORDER is
# part of the numerics contract (each one splits the key chain), so no
# pass may add, remove, or reorder them
RANDOM_OPS = frozenset({"sample_normal"})


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # filled by the graph builder
    out_shape: Optional[Shape] = None
    param_count: int = 0
    bias_params: int = 0             # the fp32-resident share of param_count
    macs: int = 0                    # multiply-accumulates
    ops: int = 0                     # total arithmetic ops (paper's metric)


def base_op(node: Node) -> str:
    """The compute op of a node — the wrapped op for ``fused`` nodes."""
    return node.attrs["base_op"] if node.op == "fused" else node.op


def param_node(node: Node) -> str:
    """The name parameters are keyed under (the original producer for a
    fused node, the node itself otherwise)."""
    return node.attrs.get("param_of", node.name)


def node_param_bytes(node: Node, weight_dtype_bytes: int = 4) -> int:
    """One node's parameter footprint with weights at
    ``weight_dtype_bytes`` and biases at fp32 (the Vitis-AI int8 layout
    keeps biases fp32) — the single definition `Graph.param_bytes` and
    the energy model's weight accounting share."""
    return ((node.param_count - node.bias_params) * weight_dtype_bytes
            + node.bias_params * 4)


class Graph:
    """A feed-forward op graph (SSA; multiple inputs, multiple outputs)."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.order: List[str] = []
        self.graph_inputs: Dict[str, Shape] = {}
        self.outputs: List[str] = []

    # -- construction -------------------------------------------------------

    def input(self, name: str, shape: Shape) -> str:
        self.graph_inputs[name] = tuple(shape)
        node = Node(name, "input", [], out_shape=tuple(shape))
        self.nodes[name] = node
        self.order.append(name)
        return name

    def add(self, op: str, inputs: Sequence[str], name: Optional[str] = None,
            **attrs) -> str:
        if name is None:
            # collision-proof auto-naming: the obvious f"{op}_{len(order)}"
            # collides with explicitly-named nodes (a tracer emitting
            # hundreds of auto-named nodes next to user-named outputs hits
            # this immediately) — bump the counter until the name is free
            i = len(self.order)
            name = f"{op}_{i}"
            while name in self.nodes:
                i += 1
                name = f"{op}_{i}"
        if name in self.nodes:
            raise ValueError(f"duplicate node {name}")
        node = Node(name, op, list(inputs), attrs)
        _infer(node, [self.nodes[i] for i in inputs])
        self.nodes[name] = node
        self.order.append(name)
        return name

    def mark_output(self, *names: str) -> None:
        self.outputs.extend(names)

    # -- accounting (Table I) -----------------------------------------------

    @property
    def n_params(self) -> int:
        return sum(n.param_count for n in self.nodes.values())

    @property
    def n_ops(self) -> int:
        return sum(n.ops for n in self.nodes.values())

    @property
    def n_macs(self) -> int:
        return sum(n.macs for n in self.nodes.values())

    def param_bytes(self, dtype_bytes: int = 4,
                    node_dtype_bytes: Optional[Dict[str, int]] = None) -> int:
        """Total parameter footprint. ``node_dtype_bytes`` maps a node
        name to its *weight* width in bytes (e.g. 1 for a PTQ int8 node);
        biases stay fp32 (4 B) — the Vitis-AI layout. Nodes absent from
        the map are charged at ``dtype_bytes``. This is what BRAM
        residency and the `CostSignature` weight-bytes use, so quantized
        models are no longer over-counted at 4 B/param."""
        if not node_dtype_bytes:
            return self.n_params * dtype_bytes
        total = 0
        for n in self.nodes.values():
            wb = node_dtype_bytes.get(n.name)
            if wb is None:
                total += n.param_count * dtype_bytes
            else:
                total += node_param_bytes(n, wb)
        return total

    def clone(self) -> "Graph":
        """Deep-enough copy for pass rewriting: nodes and ordering are
        fresh objects; attrs dicts are copied one level deep."""
        g = Graph(self.name)
        g.graph_inputs = dict(self.graph_inputs)
        g.outputs = list(self.outputs)
        g.order = list(self.order)
        for name, n in self.nodes.items():
            g.nodes[name] = dataclasses.replace(
                n, inputs=list(n.inputs), attrs=dict(n.attrs))
        return g

    def summary(self) -> str:
        lines = [f"Graph {self.name}: {self.n_params:,} params, "
                 f"{self.n_ops:,} ops"]
        for name in self.order:
            n = self.nodes[name]
            label = n.op
            if n.op == "fused":
                label = "+".join([n.attrs["base_op"]]
                                 + list(n.attrs.get("epilogue", ())))
                if n.attrs.get("requant_scale") is not None:
                    label += "+requant"
            lines.append(f"  {name:24s} {label:20s} -> {n.out_shape} "
                         f"params={n.param_count:,} ops={n.ops:,}")
        return "\n".join(lines)


def consumers(graph: Graph) -> Dict[str, List[str]]:
    """node name -> names of the nodes that read it, in graph order."""
    out: Dict[str, List[str]] = {n: [] for n in graph.nodes}
    for name in graph.order:
        for i in graph.nodes[name].inputs:
            out[i].append(name)
    return out


# ---------------------------------------------------------------------------
# Shape inference + op/param accounting
# ---------------------------------------------------------------------------


def _conv_out(size: int, k: int, stride: int, pad: str) -> int:
    if pad == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def _pool_out(size: int, k: int, stride: int) -> int:
    """VALID-window pooling output size — matches `lax.reduce_window`
    execution exactly (including odd spatial dims and stride != kernel;
    the old ``size // stride`` formula diverged whenever k != stride)."""
    if size < k:
        raise ValueError(f"pool kernel {k} exceeds input dim {size}")
    return (size - k) // stride + 1


def _infer(node: Node, ins: List[Node]) -> None:
    """Shape-inference entry point. Every failure names the node and its
    input shapes — a trace of a 200-eqn jaxpr dies with a message that
    points at the offending node, not just the op kind."""
    try:
        _infer_impl(node, ins)
    except ValueError as e:
        shapes = [i.out_shape for i in ins]
        if node.name in str(e):         # already carries full context
            raise
        raise ValueError(
            f"{node.op} node {node.name!r} (input shapes {shapes}): {e}"
        ) from e
    except (KeyError, TypeError, IndexError) as e:
        shapes = [i.out_shape for i in ins]
        raise ValueError(
            f"{node.op} node {node.name!r} (input shapes {shapes}): "
            f"{type(e).__name__}: {e}") from e


def _infer_impl(node: Node, ins: List[Node]) -> None:
    op, a = node.op, node.attrs
    shapes = [i.out_shape for i in ins]

    if op == "conv2d":
        if len(shapes[0]) != 3:
            raise ValueError(
                f"conv2d {node.name!r} needs a rank-3 HWC input, got "
                f"{shapes[0]}")
        (h, w, cin) = shapes[0]
        kh, kw = a["kernel"]
        cout, stride, pad = a["features"], a.get("stride", 1), a.get("padding", "SAME")
        groups = a.get("groups", 1)
        if cin % groups or cout % groups:
            raise ValueError(
                f"conv2d {node.name!r}: groups={groups} must divide both "
                f"cin={cin} and features={cout}")
        ho, wo = _conv_out(h, kh, stride, pad), _conv_out(w, kw, stride, pad)
        if ho <= 0 or wo <= 0:
            raise ValueError(f"conv2d {node.name!r}: kernel ({kh},{kw}) "
                             f"with padding {pad} over {shapes[0]} leaves "
                             "no output")
        node.out_shape = (ho, wo, cout)
        node.param_count = kh * kw * (cin // groups) * cout + cout
        node.bias_params = cout
        node.macs = ho * wo * cout * kh * kw * (cin // groups)
        node.ops = 2 * node.macs + ho * wo * cout
    elif op == "conv3d":
        (d, h, w, cin) = shapes[0]
        kd, kh, kw = a["kernel"]
        cout, stride, pad = a["features"], a.get("stride", 1), a.get("padding", "SAME")
        do, ho, wo = (_conv_out(d, kd, stride, pad), _conv_out(h, kh, stride, pad),
                      _conv_out(w, kw, stride, pad))
        node.out_shape = (do, ho, wo, cout)
        node.param_count = kd * kh * kw * cin * cout + cout
        node.bias_params = cout
        node.macs = do * ho * wo * cout * kd * kh * kw * cin
        node.ops = 2 * node.macs + do * ho * wo * cout
    elif op in ("maxpool2d", "avgpool2d"):
        (h, w, c) = shapes[0]
        k, stride = a["kernel"], a.get("stride", a["kernel"])
        node.out_shape = (_pool_out(h, k, stride), _pool_out(w, k, stride), c)
        node.ops = int(np.prod(node.out_shape)) * k * k
    elif op in ("maxpool3d", "avgpool3d"):
        (d, h, w, c) = shapes[0]
        k, stride = a["kernel"], a.get("stride", a["kernel"])
        node.out_shape = (_pool_out(d, k, stride), _pool_out(h, k, stride),
                          _pool_out(w, k, stride), c)
        node.ops = int(np.prod(node.out_shape)) * k ** 3
    elif op == "dense":
        fout = a["features"]
        if a.get("per_position", False):
            # token-wise projection: matmul over the LAST axis only, all
            # leading (position) axes preserved — the LM QKV/MLP shape
            if len(shapes[0]) < 1:
                raise ValueError(
                    f"dense {node.name!r}: per_position needs a rank>=1 "
                    f"input, got {shapes[0]}")
            fin = int(shapes[0][-1])
            n_pos = int(np.prod(shapes[0][:-1])) if len(shapes[0]) > 1 else 1
            node.out_shape = tuple(shapes[0][:-1]) + (fout,)
            node.macs = n_pos * fin * fout
        else:
            fin = int(np.prod(shapes[0]))
            node.out_shape = (fout,)
            node.macs = fin * fout
        node.param_count = fin * fout + (fout if a.get("bias", True) else 0)
        node.bias_params = fout if a.get("bias", True) else 0
        node.ops = 2 * node.macs + int(np.prod(node.out_shape))
    elif op == "attention":
        # scaled-dot-product attention over per-sample [S, H, hd] tensors:
        # inputs (q, k, v); GQA when Hq is a multiple of Hkv. Output has
        # the query's shape. MACs: QK^T + PV, each Sq*Sk*Hq*hd.
        if len(shapes) != 3:
            raise ValueError(
                f"attention {node.name!r} needs (q, k, v) inputs, got "
                f"{len(shapes)}")
        if any(len(s) != 3 for s in shapes):
            raise ValueError(
                f"attention {node.name!r} needs rank-3 [S,H,hd] inputs, "
                f"got {shapes}")
        (sq, hq, hd), (sk, hkv, hdk) = shapes[0], shapes[1]
        if shapes[2] != shapes[1]:
            raise ValueError(
                f"attention {node.name!r}: k {shapes[1]} and v {shapes[2]} "
                "shapes must match")
        if hdk != hd:
            raise ValueError(
                f"attention {node.name!r}: head dim mismatch q={hd} k={hdk}")
        if hq % hkv:
            raise ValueError(
                f"attention {node.name!r}: query heads {hq} must be a "
                f"multiple of KV heads {hkv}")
        node.out_shape = (sq, hq, hd)
        node.macs = 2 * sq * sk * hq * hd
        # softmax: max/sub/exp/sum/div ≈ 5 ops per score entry
        node.ops = 2 * node.macs + 5 * sq * sk * hq
    elif op == "ssd":
        # chunked state-space (Mamba-2 SSD) scan over per-sample inputs
        # x [S,H,P], B [S,N], C [S,N], dt [S,H]; per-head decay A is the
        # node's parameter vector [H]. Output matches x.
        if len(shapes) != 4:
            raise ValueError(
                f"ssd {node.name!r} needs (x, B, C, dt) inputs, got "
                f"{len(shapes)}")
        (s, h, p) = shapes[0]
        (sb, n) = shapes[1]
        if shapes[2] != shapes[1] or sb != s or shapes[3] != (s, h):
            raise ValueError(
                f"ssd {node.name!r}: inconsistent input shapes {shapes}")
        node.out_shape = (s, h, p)
        node.param_count = h               # A (fp32-resident, like biases)
        node.bias_params = h
        # state update (H*P*N) + output contraction (H*P*N) per step
        node.macs = 2 * s * h * p * n
        # + decay/exp and state blend element-wise work
        node.ops = 2 * node.macs + 3 * s * h * p * n
    elif op == "reshape":
        # static per-sample reshape (attrs["shape"], one -1 allowed) —
        # structural glue between token-major [S,D] and head-major
        # [S,H,hd] layouts; carries no arithmetic cost
        tgt = list(a["shape"])
        n_in = int(np.prod(shapes[0]))
        if tgt.count(-1) > 1:
            raise ValueError(
                f"reshape {node.name!r}: at most one -1 in {tgt}")
        if -1 in tgt:
            rest = int(np.prod([d for d in tgt if d != -1]))
            if rest == 0 or n_in % rest:
                raise ValueError(
                    f"reshape {node.name!r}: cannot infer -1 in {tgt} "
                    f"from {shapes[0]}")
            tgt[tgt.index(-1)] = n_in // rest
        if int(np.prod(tgt)) != n_in:
            raise ValueError(
                f"reshape {node.name!r}: {shapes[0]} has {n_in} elements, "
                f"target {tgt} has {int(np.prod(tgt))}")
        node.out_shape = tuple(int(d) for d in tgt)
    elif op == "flatten":
        node.out_shape = (int(np.prod(shapes[0])),)
    elif op in ("relu", "leaky_relu", "sigmoid", "tanh", "softplus", "exp"):
        node.out_shape = shapes[0]
        node.ops = int(np.prod(shapes[0])) * (4 if op in ("sigmoid", "tanh",
                                                          "softplus") else 1)
    elif op == "concat":
        ax = a.get("axis", -1)
        rank = len(shapes[0])
        if any(len(s) != rank for s in shapes):
            raise ValueError(
                f"concat {node.name!r}: input ranks differ "
                f"({[len(s) for s in shapes]})")
        if not -rank <= ax < rank:
            raise ValueError(f"concat {node.name!r}: axis {ax} out of "
                             f"range for rank-{rank} inputs")
        pos = ax + rank if ax < 0 else ax
        for s in shapes[1:]:
            mismatched = [d for d in range(rank)
                          if d != pos and s[d] != shapes[0][d]]
            if mismatched:
                raise ValueError(
                    f"concat {node.name!r}: non-axis dims differ between "
                    f"{shapes[0]} and {s} (axis={ax})")
        base = list(shapes[0])
        base[pos] = sum(s[pos] for s in shapes)
        node.out_shape = tuple(base)
    elif op in ("add", "mul", "sub"):
        node.out_shape = shapes[0]
        node.ops = int(np.prod(shapes[0]))
    elif op == "greater":
        node.out_shape = shapes[0]
        node.ops = int(np.prod(shapes[0]))
        # threshold constant counts as a parameter (ESPERTA decision level)
        node.param_count = 0
    elif op == "scale_shift":
        # y = x * w + b with per-element params (ESPERTA's tiny regressors)
        node.out_shape = shapes[0]
        n = int(np.prod(shapes[0]))
        node.param_count = 0
        node.ops = 2 * n
    elif op == "sample_normal":
        # z = mu + exp(0.5*logvar) * eps — the VAE tail the paper runs on CPU
        node.out_shape = shapes[0]
        node.ops = 3 * int(np.prod(shapes[0]))
    elif op == "argmax":
        node.out_shape = ()
        node.ops = int(np.prod(shapes[0]))
    elif op == "const":
        node.out_shape = tuple(np.shape(a["value"]))
        node.ops = 0
    elif op == "fused":
        # delegate to the base compute op, then account the epilogue as
        # element-wise ops on the output (requantize is one more op/elt)
        proxy = Node(node.name, a["base_op"], list(node.inputs),
                     {k: v for k, v in a.items()
                      if k not in ("base_op", "epilogue", "param_of",
                                   "requant_scale", "int8_input")})
        _infer(proxy, ins)
        node.out_shape = proxy.out_shape
        node.param_count = proxy.param_count
        node.bias_params = proxy.bias_params
        node.macs = proxy.macs
        n_out = int(np.prod(node.out_shape)) if node.out_shape else 1
        epi_ops = sum(4 if e in ("sigmoid", "tanh", "softplus") else 1
                      for e in a.get("epilogue", ()))
        node.ops = proxy.ops + n_out * epi_ops
        if a.get("requant_scale") is not None:
            node.ops += n_out
    else:
        raise ValueError(f"unknown op {op!r}")
