"""Quickstart — the paper's dual-toolchain workflow on one model.

Mirrors Section III of the paper end to end:
  1. build a space use-case network as an op graph (Netron analog), or
     trace it from its plain PyTorch function (``--trace``),
  2. run the operator-coverage *inspector* (Vitis-AI inspector analog),
  3. execute on all three backends: cpu (ARM baseline), flex (HLS
     analog: fp32, every op), accel (DPU analog: INT8 PTQ + the
     hand-written CUDA kernels),
  4. check the two fidelity properties the paper reports,
  5. print a Table-III-style row (measured here + modeled on the paper's
     ZCU104 DPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
          [--model vae_encoder] [--trace] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.core import inspector
from repro_torch.core.energy import ZCU104_DPU, model_graph
from repro_torch.core.engine import Engine
from repro_torch.models import SPACE_MODELS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vae_encoder",
                    choices=sorted(SPACE_MODELS))
    ap.add_argument("--trace", action="store_true",
                    help="build the op graph by tracing the model's plain "
                         "PyTorch function through the torch.fx front-end "
                         "instead of the hand-built builder (the same "
                         "graph)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    m = SPACE_MODELS[args.model]

    # 1. graph (hand-built, or traced from the function: the same result)
    graph = m.build_graph()
    params = m.init_params(0)
    if args.trace:
        from repro_torch.frontend import trace
        tm = trace(functools.partial(m.torch_forward, params),
                   dict(graph.graph_inputs), name=m.name)
        graph, params = tm.graph, tm.params
        print(f"[trace] rebuilt {m.name} from its PyTorch function: "
              f"{len(graph.order)} nodes")
    print(f"[graph] {graph.name}: {graph.n_params:,} params, "
          f"{graph.n_ops:,} ops (paper: {m.paper_params:,} / "
          f"{m.paper_ops:,})")

    # 2. inspect: which path can take it?
    report = inspector.inspect(graph)
    print(f"[inspect]\n{report.summary()}")

    # 3. execute on the three backends
    engine = Engine(graph, params, device=args.device)
    rng = np.random.default_rng(1)
    inputs = m.synthetic_input(rng)
    engine.calibrate([m.synthetic_input(rng) for _ in range(4)])
    # the plan the graph compiler built: fusion groups, int8 requant
    # chains and the activation arena
    print(f"[plan]\n{engine.planned('accel').summary()}")

    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    key = np.zeros(2, np.uint32)
    outs, lat = {}, {}
    for backend in ("cpu", "flex", "accel"):
        engine.run(inputs, backend, key)              # compile/warm-up
        sync()
        t0 = time.perf_counter()
        out = engine.run(inputs, backend, key)
        sync()
        lat[backend] = time.perf_counter() - t0
        outs[backend] = {k: v.float().cpu() for k, v in out.items()}
        print(f"[run:{backend:5s}] {lat[backend]*1e3:8.3f} ms   "
              f"outputs: {sorted(out)}")

    # 4. fidelity (paper: HLS matches CPU <= 1e-10; PTQ is 'noticeable')
    fid = max(float((outs["cpu"][k] - outs["flex"][k]).abs().max())
              for k in outs["cpu"])
    ptq = max(float((outs["flex"][k] - outs["accel"][k]).abs().max())
              for k in outs["cpu"])
    print(f"[fidelity] flex vs cpu max|delta| = {fid:.2e}   "
          f"PTQ (accel vs flex) = {ptq:.2e}")

    # 5. Table-III-style summary
    print(f"[speedup] flex {lat['cpu']/lat['flex']:.2f}x, accel "
          f"{lat['cpu']/lat['accel']:.2f}x over cpu on "
          f"{engine.device} (host clock, one B=1 run)")
    rep = model_graph(graph, ZCU104_DPU, "accel")
    print(f"[modeled zcu104 dpu accel] {rep.row()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
