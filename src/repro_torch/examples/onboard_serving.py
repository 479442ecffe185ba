"""End-to-end on-board serving driver — the paper's mission scenario.

Simulates one orbit segment of a spacecraft running two concurrent use
cases through the continuous-batching scheduler: both models served from
ONE process, round-robin, each with its own request queue, batch ladder
and mission-cadence deadline:

  * **event detection / selective downlink**: the MMS plasma-region
    classifier scans FPI ion-energy distributions and keeps only
    region-of-interest crossings (the paper's ROI use case), and
  * **compression**: the VAE encoder turns 128x256 magnetogram tiles
    into 6-float latents for downlink (1:16,384).

Requests arrive on interleaved Poisson traces (the instruments sample
independently); the scheduler fills batches up to the ladder and flushes
ragged tails when a deadline approaches. Reports per-model telemetry
(p50/p99 latency vs deadline, batch fill, fps) and the end-to-end
downlink-budget reduction.

Run:  PYTHONPATH=src python -m repro_torch.examples.onboard_serving
          [--requests 256] [--backend flex] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        capped_ladder, poisson_arrivals)
from repro_torch.models import SPACE_MODELS, synthetic_requests

FP32 = 4

USE_CASES = ("baseline_net", "vae_encoder")


def keep_mms(out) -> bool:
    # MMS ROI policy: keep MSH/MSP crossings (the paper's region-of-
    # interest trigger) PLUS low-margin (uncertain) classifications for
    # ground verification, the standard conservative on-board filter
    head = np.sort(np.asarray(out["head"]).ravel())
    margin = float(head[-1] - head[-2])
    return int(out["region"]) >= 2 or margin < 0.113


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256,
                    help="requests per use case")
    ap.add_argument("--backend", default="flex",
                    choices=["cpu", "flex", "accel"])
    ap.add_argument("--batch", type=int, default=32,
                    help="top batch-ladder rung")
    ap.add_argument("--rate", type=float, default=16.0,
                    help="per-instrument Poisson arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    print("== on-board inference: one orbit segment ==")
    ladder = capped_ladder(args.batch)
    sched = ContinuousBatchingScheduler()
    graphs, trace = {}, []
    for mi, name in enumerate(USE_CASES):
        m = SPACE_MODELS[name]
        graphs[name] = m.build_graph()
        engine = Engine(graphs[name], m.init_params(0), device=args.device)
        reqs = synthetic_requests(m, args.requests, seed=1 + mi)
        if args.backend == "accel":
            engine.calibrate(reqs[:4])
        # compression keeps everything (the latent IS the downlink product)
        keep = keep_mms if name == "baseline_net" else None
        # mission cadences: BaselineNet at the FPI fast-survey cadence
        # (4.5 s), the VAE at the SHARP product cadence (45 s)
        deadline = 4.5 if name == "baseline_net" else 45.0
        sched.register(name, engine, backend=args.backend, ladder=ladder,
                       deadline_s=deadline, keep_predicate=keep,
                       warmup_sample=reqs[0])
        trace += [(t, name, r) for t, r in
                  zip(poisson_arrivals(args.rate, args.requests, seed=mi),
                      reqs)]

    end = sched.serve_trace(trace)
    tel = sched.telemetry()
    print(f"\n[schedule] {len(trace)} requests co-served in {end:.3f} s "
          f"(virtual)\n" + sched.summary())

    totals = [0, 0]
    for name in USE_CASES:
        t = tel[name]
        in_bytes = sum(int(np.prod(s))
                       for s in graphs[name].graph_inputs.values()) * FP32
        if name == "vae_encoder":
            downlinked = t.n_completed * 6 * FP32   # latent downlink
        else:
            downlinked = t.n_kept * in_bytes        # kept raw samples
        raw = t.n_completed * in_bytes
        print(f"[{name}] downlink: raw={raw/1e6:.2f} MB -> "
              f"sent={downlinked/1e6:.4f} MB "
              f"({(1 - downlinked/raw)*100:.2f}% reduction)")
        totals[0] += raw
        totals[1] += downlinked
    print(f"\n[mission] total raw {totals[0]/1e6:.2f} MB -> downlinked "
          f"{totals[1]/1e6:.4f} MB "
          f"({(1 - totals[1]/totals[0])*100:.2f}% downlink reduction)")
    served = sum(tel[n].n_completed for n in USE_CASES)
    return 0 if served == len(trace) else 1


if __name__ == "__main__":
    raise SystemExit(main())
