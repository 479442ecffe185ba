"""Operator-coverage inspector — the Vitis-AI 'inspector' analog.

The paper's workflow: *"run the inspector to verify that all layers are
supported"* before committing a model to the DPU; unsupported models
(ESPERTA's sigmoid/greater, MMS's 3-D conv/pool) go to HLS instead. Here
the same decision is per-*node*: nodes whose op is in ACCEL_SUPPORTED run
the INT8 Pallas path, everything else runs the flexible fp32 path — with
segment analysis so partial offload (the paper's VAE sampling/exp tail on
CPU) falls out naturally.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.opgraph import Graph, Node, base_op

# The DPU-analog op table. Deliberately restrictive, mirroring DPUCZDX8G:
# CNN ops + ReLU only — no sigmoid/tanh/softplus, no comparators, no 3-D
# layers, no sampling, no exp. (INT8 MXU kernels exist for conv2d/dense.)
# `reshape` is structural data movement the DPU's DMA handles. The LM
# kernels (`attention`, `ssd`) are NOT in the table: like the paper's
# sigmoid tail they run on the flexible path, so a decoder block
# partitions into accel QKV/MLP projections around flex attention/SSM
# segments — operator coverage is exactly the survey's binding
# constraint for DPU-style accelerators.
ACCEL_SUPPORTED = {
    "conv2d", "dense", "relu", "maxpool2d", "avgpool2d", "flatten",
    "concat", "add", "reshape",
}

# Ops the accel path *executes quantized* (the rest of ACCEL_SUPPORTED are
# structural / fused into epilogues).
ACCEL_QUANTIZED = {"conv2d", "dense"}

# kinds that move no data at run time: never compute, never counted in
# operator-coverage reports, never split a backend segment
STRUCTURAL_KINDS = ("input", "const")


def accel_supports(node: Node) -> bool:
    """Per-NODE accel support — the op table plus attr-level restrictions
    the int8 kernels carry: grouped (e.g. depthwise) conv2d has no
    shift-and-matmul kernel, so it runs on the flex path even though
    plain conv2d is supported."""
    bop = base_op(node)
    if bop not in ACCEL_SUPPORTED:
        return False
    if bop == "conv2d" and node.attrs.get("groups", 1) != 1:
        return False
    return True


@dataclasses.dataclass
class InspectionReport:
    graph_name: str
    supported: List[str]
    unsupported: List[str]
    fully_supported: bool
    mac_coverage: float             # fraction of MACs accel can take
    segments: List[dict]            # contiguous backend runs, in order

    def summary(self) -> str:
        status = "ACCEL (fully supported)" if self.fully_supported else \
            f"PARTIAL ({self.mac_coverage:.1%} of MACs on accel)"
        lines = [f"{self.graph_name}: {status}"]
        if self.unsupported:
            lines.append(f"  unsupported ops: "
                         f"{sorted(set(self.unsupported))}")
        for seg in self.segments:
            lines.append(f"  [{seg['backend']:5s}] {seg['first']} .. "
                         f"{seg['last']} ({seg['n']} nodes)")
        return "\n".join(lines)


def assign_backends(graph: Graph) -> Dict[str, str]:
    out = {}
    for name in graph.order:
        node = graph.nodes[name]
        if node.op in STRUCTURAL_KINDS:         # structural, no compute
            out[name] = "accel"
            continue
        # a fused node goes where its base compute op goes (its epilogue
        # runs inside the kernel — DESIGN.md §10)
        out[name] = "accel" if accel_supports(node) else "flex"
    return out


def inspect(graph: Graph) -> InspectionReport:
    assignment = assign_backends(graph)
    supported, unsupported = [], []
    for name in graph.order:
        node = graph.nodes[name]
        if node.op in STRUCTURAL_KINDS:
            # const nodes (constant folding; tracer-captured literals)
            # are structural like inputs — counting them into supported/
            # fully_supported would report plan-time values as compute
            # ops the accelerator "runs"
            continue
        (supported if assignment[name] == "accel" else unsupported
         ).append(node.op)
    macs = graph.n_macs or 1
    accel_macs = sum(n.macs for n in graph.nodes.values()
                     if assignment[n.name] == "accel")

    from repro_torch.core.plan import partition_segments
    segments = [{"backend": seg.backend, "first": seg.nodes[0],
                 "last": seg.nodes[-1], "n": len(seg.nodes)}
                for seg in partition_segments(graph, assignment)]
    return InspectionReport(
        graph_name=graph.name,
        supported=supported,
        unsupported=unsupported,
        fully_supported=not unsupported,
        mac_coverage=accel_macs / macs,
        segments=segments,
    )
