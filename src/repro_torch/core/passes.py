"""Graph-compiler pass pipeline — rewrites the op graph before lowering
(DESIGN.md §10).

The paper's custom HLS designs beat op-by-op DPU dispatch because they
stream layer outputs through on-chip buffers instead of round-tripping
DDR between every operator. The seed planner lowered one node at a time:
each int8 conv/dense dequantized to fp32, wrote a full activation, and
the next node requantized it. This module is the missing middle stage —
a small multi-pass graph compiler the `ExecutionPlan` runs between the
inspector's backend assignment and segment partitioning:

* **constant folding** — subgraphs with no path from any graph input are
  evaluated once at plan time and replaced by ``const`` nodes.
* **dead-node elimination** — nodes from which no graph output is
  reachable are dropped.
* **epilogue fusion** — a sole-consumer relu/sigmoid folds into its
  producing conv2d/dense as a ``fused`` node (the act node's *name*, so
  downstream references and graph outputs keep resolving; parameters
  stay keyed under the producer via ``param_of``). On the accel path a
  sigmoid epilogue runs inside the int8 kernel's fp32 epilogue — the
  HLS idiom of streaming the activation right after the MAC array.
* **requant fusion** — the headline: an int8 producer whose value flows
  (possibly through int8-safe ``maxpool2d``/``flatten``) only into int8
  consumers gets a ``requant_scale``: the kernel re-quantizes its output
  to int8 *in the epilogue* at the consumers' calibration scale, the
  chain ops run in the int8 domain, and the consumers take int8 input
  directly — no fp32 dequant round-trip ever touches DDR. Exactness:
  ``clip(round(x/s))`` is monotone, so it commutes with max-pooling and
  reshape bit-for-bit; the consumer sees the very same int8 values the
  unfused plan would have computed.

Every pass records what it did in a :class:`PassReport`; the
`ExecutionPlan.summary()` prints the fusion groups, and a ``fuse=False``
engine skips this module entirely (the escape hatch that reproduces the
pre-pass plans node-for-node).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.opgraph import (FUSABLE_EPILOGUES, RANDOM_OPS, Graph,
                                Node, base_op, consumers, param_node)

# ops whose value the requant-fusion pass may keep in the int8 domain:
# max-pooling commutes with the monotone quantizer, flatten is a reshape.
INT8_SAFE_CHAIN_OPS = frozenset({"maxpool2d", "flatten"})

# ops that cannot be constant-folded at plan time (need per-call state)
UNFOLDABLE = RANDOM_OPS | {"input", "const", "fused"}


@dataclasses.dataclass(frozen=True)
class FusionGroup:
    """One epilogue fusion: (producer + act) -> fused node ``name``."""
    name: str                       # the fused node (the act node's name)
    base: str                       # conv2d | dense
    param_of: str                   # original producer (params key)
    epilogue: Tuple[str, ...]       # ('relu',) | ('sigmoid',)
    backend: str


@dataclasses.dataclass(frozen=True)
class RequantGroup:
    """One int8 producer->consumer fusion: ``producer`` requantizes in
    its epilogue, ``chain`` runs int8, ``consumers`` take int8 input."""
    producer: str
    chain: Tuple[str, ...]
    consumers: Tuple[str, ...]
    scale: float


@dataclasses.dataclass
class PassReport:
    folded: List[str] = dataclasses.field(default_factory=list)
    eliminated: List[str] = dataclasses.field(default_factory=list)
    fusion_groups: List[FusionGroup] = dataclasses.field(default_factory=list)
    requant_groups: List[RequantGroup] = dataclasses.field(
        default_factory=list)
    kv_int8_nodes: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_rewrites(self) -> int:
        return (len(self.folded) + len(self.eliminated)
                + len(self.fusion_groups) + len(self.requant_groups)
                + len(self.kv_int8_nodes))

    def summary(self) -> str:
        lines = []
        if self.folded:
            lines.append(f"  const-folded: {self.folded}")
        if self.eliminated:
            lines.append(f"  dead nodes eliminated: {self.eliminated}")
        for fg in self.fusion_groups:
            lines.append(f"  fused [{fg.backend}] {fg.param_of} + "
                         f"{'+'.join(fg.epilogue)} -> {fg.name}")
        for rq in self.requant_groups:
            via = f" via {list(rq.chain)}" if rq.chain else ""
            lines.append(f"  int8-chain {rq.producer}{via} -> "
                         f"{list(rq.consumers)} (requant s={rq.scale:.3g})")
        if self.kv_int8_nodes:
            lines.append(f"  int8 KV stream: {self.kv_int8_nodes}")
        return "\n".join(lines) if lines else "  (no rewrites)"


@dataclasses.dataclass
class PassContext:
    """Everything a pass may consult or update. ``assignment`` is the
    inspector's per-node backend map (post PTQ-demotion) and is kept in
    sync with rewrites; ``quant``/``act_absmax`` are the PTQ constants
    (None / empty on flex plans)."""
    params: Dict[str, Dict[str, Any]]
    assignment: Dict[str, str]
    quant: Optional[Dict[str, Any]] = None
    act_absmax: Optional[Dict[str, float]] = None


def _is_quantized_compute(node: Node, ctx: PassContext) -> bool:
    """Does this node run on the int8 accel kernels under ``ctx``?"""
    return (base_op(node) in ("conv2d", "dense")
            and ctx.quant is not None
            and param_node(node) in ctx.quant
            and ctx.assignment.get(node.name) == "accel")


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------


def constant_fold(graph: Graph, ctx: PassContext,
                  report: PassReport) -> Graph:
    """Evaluate nodes with no transitive dependence on a graph input once
    at plan time; replace each with a ``const`` node of the same name."""
    from repro_torch.core.engine import OP_IMPLS      # late: engine imports plan

    values: Dict[str, np.ndarray] = {}
    for name in graph.order:
        node = graph.nodes[name]
        if node.op == "const":
            values[name] = np.asarray(node.attrs["value"])
            continue
        if node.op in UNFOLDABLE or not node.inputs:
            continue
        if not all(i in values for i in node.inputs):
            continue
        out = OP_IMPLS[node.op]([values[i] for i in node.inputs],
                                ctx.params.get(name, {}), node.attrs, None)
        values[name] = np.asarray(out)
        folded = Node(name, "const", [], {"value": values[name]},
                      out_shape=tuple(values[name].shape))
        graph.nodes[name] = folded
        ctx.assignment[name] = ctx.assignment.get(name, "flex")
        report.folded.append(name)
    return graph


def eliminate_dead_nodes(graph: Graph, ctx: PassContext,
                         report: PassReport) -> Graph:
    """Drop nodes from which no graph output is reachable (inputs stay —
    they define the lowered call signature; random ops stay too, dead or
    not: each one advances the per-sample RNG split chain, so removing
    one would shift every later random node's keys and break the
    fused==unfused bit-exactness contract)."""
    live = set(graph.outputs) | {n.name for n in graph.nodes.values()
                                 if n.op in RANDOM_OPS}
    for name in reversed(graph.order):
        if name in live:
            live.update(graph.nodes[name].inputs)
    removed = [n for n in graph.order
               if n not in live and graph.nodes[n].op != "input"]
    for name in removed:
        del graph.nodes[name]
        graph.order.remove(name)
        ctx.assignment.pop(name, None)
        report.eliminated.append(name)
    return graph


def fuse_epilogues(graph: Graph, ctx: PassContext,
                   report: PassReport) -> Graph:
    """Fold a sole-consumer relu/sigmoid into its producing conv2d/dense.

    The rewritten node takes the ACT node's name (so downstream inputs
    and graph outputs keep resolving) and points at the producer's
    parameters via ``param_of``. Quantized producers may absorb any
    fusable epilogue — it runs inside the kernel's fp32 epilogue — which
    pulls e.g. ESPERTA's sigmoid onto the accel segment; fp32 producers
    only fuse with an act already assigned to the same backend.
    """
    cons = consumers(graph)
    for name in list(graph.order):
        node = graph.nodes.get(name)
        if node is None or node.op not in ("conv2d", "dense"):
            continue
        if name in graph.outputs or len(cons[name]) != 1:
            continue
        act_name = cons[name][0]
        act = graph.nodes[act_name]
        if act.op not in FUSABLE_EPILOGUES:
            continue
        quantized = _is_quantized_compute(node, ctx)
        backend = ctx.assignment.get(name, "flex")
        if not quantized and ctx.assignment.get(act_name) != backend:
            continue
        attrs = dict(node.attrs)
        attrs.update(base_op=node.op, epilogue=(act.op,), param_of=name)
        fused = Node(act_name, "fused", list(node.inputs), attrs)
        from repro_torch.core.opgraph import _infer
        _infer(fused, [graph.nodes[i] for i in node.inputs])
        # the fused node takes the PRODUCER's slot (its inputs are the
        # producer's, so defining it early keeps their liveness tight);
        # the act's original slot is deleted
        idx = graph.order.index(name)
        graph.order[idx] = act_name
        del graph.order[graph.order.index(act_name, idx + 1)]
        del graph.nodes[name]
        graph.nodes[act_name] = fused
        ctx.assignment.pop(name, None)
        ctx.assignment[act_name] = backend
        # keep the consumer map usable for later candidates in this walk
        cons[act_name] = cons.get(act_name, [])
        report.fusion_groups.append(FusionGroup(
            act_name, attrs["base_op"], name, attrs["epilogue"], backend))
    return graph


def fuse_requant(graph: Graph, ctx: PassContext,
                 report: PassReport) -> Graph:
    """Keep int8 producer->consumer values on-chip: the producer
    requantizes in its kernel epilogue at the consumers' calibration
    scale, int8-safe chain ops stay in the int8 domain, and consumers
    skip their own quantize step. Bit-exact vs the unfused plan because
    the quantizer is monotone (commutes with maxpool) and flatten is a
    reshape — see module docstring."""
    if ctx.quant is None or not ctx.act_absmax:
        return graph
    cons = consumers(graph)
    for name in graph.order:
        node = graph.nodes[name]
        if not _is_quantized_compute(node, ctx) or name in graph.outputs:
            continue
        if node.attrs.get("requant_scale") is not None:
            continue
        chain: List[str] = []
        cur = name
        endpoints: Tuple[str, ...] = ()
        while True:
            cs = cons.get(cur, [])
            if not cs:
                break
            if (len(cs) == 1 and graph.nodes[cs[0]].op in INT8_SAFE_CHAIN_OPS
                    and cs[0] not in graph.outputs
                    and ctx.assignment.get(cs[0]) == "accel"):
                chain.append(cs[0])
                cur = cs[0]
                continue
            if all(_is_quantized_compute(graph.nodes[c], ctx)
                   and not graph.nodes[c].attrs.get("int8_input")
                   for c in cs):
                endpoints = tuple(cs)
            break
        if not endpoints:
            continue
        absmax = ctx.act_absmax.get(cur)
        if absmax is None:
            continue
        # the exact scale the unfused consumers would quantize with
        from repro_torch.core.quantize import act_scale
        scale = act_scale(absmax)
        node.attrs["requant_scale"] = scale
        for t in chain:
            graph.nodes[t].attrs["int8"] = True
        for e in endpoints:
            graph.nodes[e].attrs["int8_input"] = True
        report.requant_groups.append(
            RequantGroup(name, tuple(chain), endpoints, scale))
    return graph


def annotate_kv_int8(graph: Graph, ctx: PassContext,
                     report: PassReport) -> Graph:
    """INT8 KV-stream annotation (LM serving — DESIGN.md §15): on a
    quantized (accel) plan, every attention node's K/V values go through
    the `lm_quant.quantize_kv`/`dequantize_kv` per-(position, head)
    round-trip — the same codes the KV-cache arena stores at decode
    time, applied already in the prefill graph so prefill attention
    output is bit-identical to what cached decode reconstructs. A
    builder may pin ``kv_int8=False`` on a node to opt it out. (The
    ``fuse=False`` escape hatch skips this pass like any other, so an
    unfused accel LM plan streams fp32 K/V — the LM engine requires the
    pass pipeline.)"""
    if ctx.quant is None:
        return graph
    for name in graph.order:
        node = graph.nodes[name]
        if base_op(node) == "attention" and "kv_int8" not in node.attrs:
            node.attrs["kv_int8"] = True
            report.kv_int8_nodes.append(name)
    return graph


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

PassFn = Callable[[Graph, PassContext, PassReport], Graph]

DEFAULT_PASSES: Tuple[Tuple[str, PassFn], ...] = (
    ("constant_fold", constant_fold),
    ("dead_node_elimination", eliminate_dead_nodes),
    ("epilogue_fusion", fuse_epilogues),
    ("requant_fusion", fuse_requant),
    ("kv_int8_annotation", annotate_kv_int8),
)


class PassManager:
    """Runs an ordered pass list over a CLONE of the graph (the engine's
    source graph is never mutated) and returns the rewritten graph plus
    the report the plan summary prints."""

    def __init__(self,
                 passes: Optional[Sequence[Tuple[str, PassFn]]] = None):
        self.passes = tuple(passes if passes is not None else DEFAULT_PASSES)

    def run(self, graph: Graph, ctx: PassContext
            ) -> Tuple[Graph, PassReport]:
        g = graph.clone()
        report = PassReport()
        for _, fn in self.passes:
            g = fn(g, ctx, report)
        _check_consistency(g)
        return g, report


def _check_consistency(graph: Graph) -> None:
    """Pass-pipeline invariants: order is a permutation of nodes, every
    input reference resolves, outputs resolve, topological order holds."""
    assert sorted(graph.order) == sorted(graph.nodes), "order != nodes"
    seen = set()
    for name in graph.order:
        for i in graph.nodes[name].inputs:
            assert i in seen, f"{name} reads {i} before its definition"
        seen.add(name)
    for o in graph.outputs:
        assert o in graph.nodes, f"output {o} does not resolve"
