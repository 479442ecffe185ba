"""INT8 post-training quantization — the Vitis-AI quantizer analog.

PTQ: per-output-channel symmetric weight scales (absmax/127), per-tensor
activation scales collected by running the calibration set through the
fp32 graph and recording absmax at every node output. (QAT fake-quant is
not ported yet.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.opgraph import Graph
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sample import split


@dataclasses.dataclass
class QuantizedLayer:
    w_q: torch.Tensor               # int8 [K, N] (dense) / [KH*KW*Cin, Cout]
    w_scale: torch.Tensor           # f32 [N] per-output-channel
    bias: Optional[torch.Tensor]    # f32 [N]

    def to(self, device) -> "QuantizedLayer":
        return QuantizedLayer(
            self.w_q.to(device), self.w_scale.to(device),
            None if self.bias is None else self.bias.to(device))


def act_scale(absmax: float) -> float:
    """THE static per-tensor activation scale: calibration absmax / 127
    (+eps against zero tensors). One definition on purpose: a fused
    producer's requantize scale and the unfused consumer's quantize scale
    must be the same float."""
    return float(absmax) / 127.0 + 1e-12


def quantize_weights(graph: Graph, params: Dict[str, Dict[str, torch.Tensor]]
                     ) -> Dict[str, QuantizedLayer]:
    """Per-output-channel INT8 for every conv2d/dense node (one
    ``quantize_apply`` launch per layer on the card)."""
    out: Dict[str, QuantizedLayer] = {}
    for name in graph.order:
        node = graph.nodes[name]
        if node.op not in ("conv2d", "dense"):
            continue
        p = params[name]
        w = p["w"]
        w2 = w.reshape(-1, w.shape[-1]) if node.op == "conv2d" else w
        w_q, w_scale = kops.quantize(w2, axis=0)
        out[name] = QuantizedLayer(w_q=w_q, w_scale=w_scale, bias=p.get("b"))
    return out


def calibrate_graph(engine, sample_inputs: List[Dict[str, np.ndarray]],
                    traces: Optional[List[Dict[str, torch.Tensor]]] = None
                    ) -> Dict[str, float]:
    """Per-node activation absmax over a calibration set (fp32 run)."""
    absmax: Dict[str, float] = {}
    if traces is None:
        traces = [_trace(engine, s) for s in sample_inputs]
    for vals in traces:
        for name, v in vals.items():
            m = float(torch.max(torch.abs(v.float())))
            absmax[name] = max(absmax.get(name, 0.0), m)
    return absmax


def ptq_error_ratios(engine, sample_inputs: List[Dict[str, np.ndarray]],
                     quant: Dict[str, QuantizedLayer],
                     absmax: Dict[str, float],
                     traces: Optional[List[Dict[str, torch.Tensor]]] = None
                     ) -> Dict[str, float]:
    """Per-node PTQ fidelity: max over the calibration set of
    ``max|quantized_out - fp32_out| / absmax(fp32_out)`` for every
    conv2d/dense node, simulated in fp32. The planner demotes nodes whose
    ratio exceeds the engine's threshold to the flex path."""
    from repro_torch.core.engine import OP_IMPLS
    g = engine.graph
    ratios: Dict[str, float] = {}
    if traces is None:
        traces = [_trace(engine, s) for s in sample_inputs]
    for name, q in quant.items():
        node = g.nodes[name]
        inp = node.inputs[0]
        s = act_scale(absmax.get(inp, 0.0))
        w = engine.params[name]["w"]
        w_hat = (q.w_q.float() * q.w_scale[None, :]).reshape(w.shape)
        p_hat = dict(engine.params[name], w=w_hat)
        worst = 0.0
        for vals in traces:
            x_hat = torch.clamp(torch.round(vals[inp] / s), -127, 127) * s
            out_q = OP_IMPLS[node.op]([x_hat], p_hat, node.attrs, None)
            ref = vals[name]
            err = float(torch.max(torch.abs(out_q - ref)))
            scale = float(torch.max(torch.abs(ref))) + 1e-12
            worst = max(worst, err / scale)
        ratios[name] = worst
    return ratios


def _trace(engine, inputs) -> Dict[str, torch.Tensor]:
    """One fp32 single-sample pass recording every node's value. Each
    non-constant node takes the next key of a split chain from key (0, 0),
    as the reference's trace does (only random ops read it)."""
    from repro_torch.core.engine import OP_IMPLS
    g = engine.graph
    vals: Dict[str, torch.Tensor] = {}
    rng = np.zeros((1, 2), np.uint64)
    for name in g.graph_inputs:
        vals[name] = torch.as_tensor(np.asarray(inputs[name], np.float32),
                                     device=engine.device)
    for name in g.order:
        node = g.nodes[name]
        if node.op == "input":
            continue
        if node.op == "const":
            vals[name] = torch.as_tensor(np.asarray(node.attrs["value"]),
                                         device=engine.device)
            continue
        both = split(rng)
        rng, sub = both[:, 0], both[:, 1]
        vals[name] = OP_IMPLS[node.op]([vals[i] for i in node.inputs],
                                       engine.params.get(name, {}),
                                       node.attrs,
                                       torch.from_numpy(sub.astype(np.int64)))
    return vals
