"""QAT vs PTQ — the paper's stated mitigation, on the port.

The paper: *"PTQ caused noticeable degradation that QAT could mitigate."*
This example measures that degradation on a space model and then runs
quantization-aware fine-tuning (straight-through-estimator fake-quant,
``core/quantize.py``) against the fp32 model's outputs (self-distillation:
no mission data needed on board), showing the INT8 output error shrink,
and serves the fine-tuned weights on ``accel``.

The forward is the graph executed node by node over the flex path's op
implementations (``core/engine.py: OP_IMPLS``), differentiable by
``torch.autograd``; each node takes the next key of a split chain from
key (0, 0), as the reference's example splits its rng per node, so the
VAE's sample draws the same eps (and its gradient flows through the
sampler, the kernel on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.qat_finetune
          [--model logistic_net] [--steps 150] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import OP_IMPLS, Engine
from repro_torch.core.opgraph import Graph
from repro_torch.core.quantize import qat_quantize_params
from repro_torch.device import resolve_device
from repro_torch.kernels.sample import split
from repro_torch.models import SPACE_MODELS

Params = Dict[str, Dict[str, torch.Tensor]]


def forward(graph: Graph, params: Params, inputs: Dict[str, np.ndarray],
            rng: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """Differentiable single-sample graph execution on the params' device
    (the same op impls as the flex path); ``rng`` is the raw key the
    per-node split chain starts from (key (0, 0) by default)."""
    device = next(iter(next(iter(params.values())).values())).device
    vals = {k: torch.as_tensor(np.asarray(inputs[k], np.float32),
                               device=device)
            for k in graph.graph_inputs}
    rng = np.zeros((1, 2), np.uint64) if rng is None else \
        np.asarray(rng, np.uint64).reshape(1, 2)
    for name in graph.order:
        node = graph.nodes[name]
        if node.op == "input":
            continue
        both = split(rng)
        rng, sub = both[:, 0], both[:, 1]
        vals[name] = OP_IMPLS[node.op](
            [vals[i] for i in node.inputs], params.get(name, {}),
            node.attrs, torch.from_numpy(sub.astype(np.int64)))
    return {o: vals[o] for o in graph.outputs}


def float_outputs(graph: Graph) -> List[str]:
    """The outputs decisions read as values (argmax/greater are not)."""
    return [o for o in graph.outputs
            if graph.nodes[o].op not in ("argmax", "greater")]


def distill_loss(graph: Graph, params: Params, teacher: Params,
                 sample: Dict[str, np.ndarray]) -> torch.Tensor:
    """``sum_o mean((quantized(params)(x)_o - teacher(x)_o)^2)`` over the
    float outputs, both forwards from key (0, 0)."""
    with torch.no_grad():
        ref = forward(graph, teacher, sample)
    out = forward(graph, qat_quantize_params(params, graph), sample)
    return sum(torch.mean((out[o] - ref[o]) ** 2)
               for o in float_outputs(graph))


def distill_step(graph: Graph, params: Params, teacher: Params,
                 sample: Dict[str, np.ndarray], lr: float
                 ) -> Tuple[Params, torch.Tensor, Params]:
    """One SGD step on one sample: ``(new params, loss, gradients)``."""
    leaves = {n: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for n, p in params.items()}
    loss = distill_loss(graph, leaves, teacher, sample)
    flat = [v for p in leaves.values() for v in p.values()]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(v) if d is None else d
              for v, d in zip(flat, grads))
    g = {n: {k: next(it) for k in p} for n, p in leaves.items()}
    new = {n: {k: (v - lr * g[n][k]).detach() for k, v in p.items()}
           for n, p in leaves.items()}
    return new, loss.detach(), g


def quant_err(graph: Graph, params: Params, teacher: Params,
              samples) -> Tuple[float, float]:
    """(rms, max) INT8-vs-fp32-teacher output error over ``samples``."""
    sq, mx, n = 0.0, 0.0, 0
    with torch.no_grad():
        q = qat_quantize_params(params, graph)
        for s in samples:
            ref = forward(graph, teacher, s)
            out = forward(graph, q, s)
            for o in float_outputs(graph):
                d = (ref[o] - out[o]).double()
                sq += float(torch.sum(d * d))
                n += d.numel()
                mx = max(mx, float(d.abs().max()))
    return (sq / n) ** 0.5, mx


def sample_batch(model, rng: np.random.Generator, n: int):
    return [model.synthetic_input(rng) for _ in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vae_encoder",
                    choices=sorted(SPACE_MODELS))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    m = SPACE_MODELS[args.model]
    graph = m.build_graph()
    params = {n: {k: v.to(device) for k, v in p.items()}
              for n, p in m.init_params(0).items()}
    teacher = {n: dict(p) for n, p in params.items()}

    eval_samples = sample_batch(m, np.random.default_rng(99), args.batch)
    rms0, max0 = quant_err(graph, params, teacher, eval_samples)
    print(f"[ptq] INT8 output error before QAT: rms={rms0:.4e} "
          f"max={max0:.4e}")

    # QAT: minimise ||quantized(params)(x) - fp32_teacher(x)||^2 with STE
    rng = np.random.default_rng(3)
    for i in range(args.steps):
        for s in sample_batch(m, rng, args.batch):
            params, loss, _ = distill_step(graph, params, teacher, s,
                                           args.lr)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"  qat step {i:4d}  distill loss {float(loss):.3e}")

    rms1, max1 = quant_err(graph, params, teacher, eval_samples)
    print(f"[qat] INT8 output error after {args.steps} QAT steps: "
          f"rms={rms1:.4e} max={max1:.4e} "
          f"(rms {rms0 / max(rms1, 1e-12):.1f}x better)")

    # the fine-tuned weights still run through the INT8 engine path
    engine = Engine(graph, params, device=device)
    engine.calibrate(eval_samples[:4])
    out = engine.run(eval_samples[0], "accel")
    print(f"[engine] accel outputs after QAT: {sorted(out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
