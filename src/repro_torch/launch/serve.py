"""Serving launcher — the paper's on-board inference scenario, space mode.

Serves one or more space use-case models through the continuous-batching
scheduler (engine + precompiled batch ladder + deadline flushing), with
each use case's selective-downlink predicate. ``--model`` takes a comma
list to co-serve several models; requests arrive on a per-model Poisson
trace at ``--rate`` req/s. ``--backend`` takes a comma list (primary
first); under ``--power-budget WATTS`` dispatch becomes energy-aware and
falls back to the cheaper-power backends when the envelope refuses the
primary.

``--mode lm`` serves the telemetry LM's decoder block instead (the
reference's compiled LM path, ``serve_lm_compiled``): PTQ calibration,
the compiled prefill ladder and per-rung decode programs over static int8
KV slots, driven by the LM scheduler. ``--requests`` prompts of
``--tokens`` new tokens each share ``--slots`` KV slots.

``--autotune`` (both modes) tunes each batch rung's kernel schedule at
lowering and prepacks the int8 weights into tile-aligned arena buffers;
``--tuning-cache PATH`` keeps the picks in a JSON file that a later run
reads back without searching, and ``--autotune-measure`` times the top
picks that launch different kernels on the card (the conv's channel
blocking) and keeps the fastest; on the CPU nothing differs and nothing is
timed. Tuned and untuned plans give bit-identical int8
outputs.

Runs on the card; ``--device cpu`` runs every kernel's plain PyTorch
version on the CPU instead.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode space \\
        --model cnet_plus_scalar --backend accel --requests 48 --batch 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --backend accel --requests 8 --tokens 16 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mode space \\
        --model cnet_plus_scalar --backend accel --autotune \\
        --tuning-cache tuning.json
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import inspector
from repro_torch.core.energy import PowerEnvelope
from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import (BACKENDS, ContinuousBatchingScheduler,
                                        capped_ladder, poisson_arrivals)
from repro_torch.models import SPACE_MODELS, synthetic_requests

# selective-downlink predicates per use case (the paper's decision layer)
KEEP_PREDICATES = {
    # MMS: keep only magnetosheath/magnetopause crossings (classes 2, 3)
    "baseline_net": lambda out: int(out["region"]) >= 2,
    "reduced_net": lambda out: int(out["region"]) >= 2,
    "logistic_net": lambda out: int(out["region"]) >= 2,
    # ESPERTA: keep if any of the six models warns
    "multi_esperta": lambda out: any(
        float(np.max(v)) > 0 for k, v in out.items() if k.startswith("warn")),
    # CNet: keep high predicted X-ray flux
    "cnet_plus_scalar": lambda out: float(np.max(list(out.values())[0])) > 0.0,
    # VAE: everything downlinks (it IS the compressed product)
    "vae_encoder": lambda out: True,
}


def autotune_options(args) -> dict:
    """The Engine's autotune keyword arguments from the launcher flags;
    ``--tuning-cache``/``--autotune-measure`` without ``--autotune`` is a
    usage error (they would be ignored silently otherwise)."""
    if (args.tuning_cache or args.autotune_measure) and not args.autotune:
        raise SystemExit("--tuning-cache/--autotune-measure configure the "
                         "plan-time autotuner; pass --autotune to enable it")
    return dict(autotune=args.autotune, tuning_cache=args.tuning_cache,
                autotune_measure=args.autotune_measure)


def build_scheduler(args) -> tuple:
    """Parse the model/backend lists, build and calibrate one engine per
    model, register each with the scheduler, and make the arrival trace.
    Returns ``(scheduler, trace, engines)``."""
    names = [n.strip() for n in args.model.split(",") if n.strip()]
    unknown = [n for n in names if n not in SPACE_MODELS]
    if unknown or not names:
        raise SystemExit(f"unknown model(s) {unknown}; choose from "
                         f"{', '.join(sorted(SPACE_MODELS))}")
    backends = tuple(b.strip() for b in args.backend.split(",") if b.strip())
    bad = [b for b in backends if b not in BACKENDS]
    if bad or not backends:
        raise SystemExit(f"unknown backend(s) {bad}; choose from "
                         f"{', '.join(BACKENDS)}")
    ladder = capped_ladder(args.batch)

    envelope = None
    if args.power_budget is not None or args.peak_w is not None:
        envelope = PowerEnvelope(
            sustained_w=(float("inf") if args.power_budget is None
                         else args.power_budget),
            peak_w=args.peak_w, burst_j=args.burst_j,
            window_s=args.window_s)
        print(f"[envelope] sustained={args.power_budget} W  "
              f"peak={args.peak_w} W  burst={args.burst_j} J  "
              f"window={args.window_s} s  clock={args.clock}")
    elif args.burst_j != 0.0 or args.window_s != 10.0:
        raise SystemExit("--burst-j/--window-s configure the power "
                         "envelope; pass --power-budget and/or --peak-w "
                         "to enable it")
    tune = autotune_options(args)
    sched = ContinuousBatchingScheduler(envelope=envelope, clock=args.clock,
                                        pipeline=args.pipeline,
                                        staging_buffers=args.staging_buffers)
    if args.pipeline:
        print(f"[pipeline] async ticket dispatch on, "
              f"{args.staging_buffers} staging buffer(s) per (model, rung)")

    trace, engines = [], {}
    for mi, name in enumerate(names):
        m = SPACE_MODELS[name]
        graph = m.build_graph()
        engine = Engine(graph, m.init_params(1), fuse=not args.no_fuse,
                        device=args.device, **tune)
        print(inspector.inspect(graph).summary())
        reqs = synthetic_requests(m, args.requests, seed=mi)
        if "accel" in backends:
            print(f"[ptq] {name}: calibrating on 4 samples")
            engine.calibrate(reqs[:4])
        sched.register(name, engine, backend=backends, ladder=ladder,
                       keep_predicate=KEEP_PREDICATES.get(name),
                       warmup_sample=reqs[0] if reqs else None)
        engines[name] = engine
        trace += [(t, name, r) for t, r in
                  zip(poisson_arrivals(args.rate, args.requests, seed=mi),
                      reqs)]
    return sched, trace, engines


def serve_space(args) -> int:
    sched, trace, _ = build_scheduler(args)
    t0 = time.perf_counter()
    end = sched.serve_trace(trace)
    wall = time.perf_counter() - t0
    print(f"[serve] {len(trace)} requests over {len(sched.models)} model(s)  "
          f"virtual={end:.3f} s  wall={wall:.3f} s")
    print(sched.summary())
    return 0


def build_lm_scheduler(args, cfg=None) -> tuple:
    """The LM path's set-up: the decoder block at ``cfg`` (the reference's
    small default when None) with seeded weights, PTQ calibration on 8
    synthetic windows for ``accel``, the :class:`LMEngine` over
    ``args.slots`` KV slots, and an :class:`LMScheduler` holding
    ``args.requests`` submitted prompts. Returns ``(scheduler, engine)``."""
    from repro_torch.core.lm import LMEngine
    from repro_torch.core.scheduler import LMRequest, LMScheduler
    from repro_torch.models import lm as lm_model

    cfg = lm_model.DEFAULT_CONFIG if cfg is None else cfg
    backend = args.backend.split(",")[0].strip()
    if backend not in BACKENDS:
        raise SystemExit(f"unknown backend {backend!r}; choose from "
                         f"{', '.join(BACKENDS)}")
    tune = autotune_options(args)
    graph = lm_model.build_graph(cfg)
    engine = Engine(graph, lm_model.init_params(0, cfg), device=args.device,
                    **tune)
    if backend == "accel":
        rng = np.random.default_rng(1)
        engine.calibrate([lm_model.synthetic_input(rng, cfg)
                          for _ in range(8)])
    tokens = max(args.tokens, 1)
    lm = LMEngine(engine, backend=backend, n_slots=args.slots,
                  max_new_tokens=tokens)
    print(lm.plan.summary())
    sched = LMScheduler(lm)
    rng = np.random.default_rng(7)
    for rid in range(args.requests):
        sched.submit(LMRequest(
            rid=rid,
            x=rng.normal(size=(cfg.seq_len, cfg.d_model)
                         ).astype(np.float32) * 0.5,
            max_new_tokens=tokens))
    return sched, lm


def serve_lm_compiled(args, cfg=None) -> int:
    """The scheduler-native LM path: serve every submitted prompt to
    completion and report; exit code 1 unless all completed."""
    sched, _ = build_lm_scheduler(args, cfg)
    comps = sched.run()
    print(sched.summary())
    sample = comps[0].tokens[:16] if comps else ()
    print(f"[lm] sample continuation: {list(sample)}")
    return 0 if len(comps) == args.requests else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="space", choices=["space", "lm"])
    ap.add_argument("--model", default="cnet_plus_scalar",
                    help="comma list of space models to co-serve "
                         f"({', '.join(sorted(SPACE_MODELS))})")
    ap.add_argument("--backend", default="flex",
                    help="comma list of backends, primary first "
                         "(cpu, flex, accel); later entries are the "
                         "power-envelope fallbacks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests per model")
    ap.add_argument("--tokens", type=int, default=32,
                    help="--mode lm: new tokens per request")
    ap.add_argument("--slots", type=int, default=4,
                    help="--mode lm: KV-cache slots (the top prefill rung)")
    ap.add_argument("--batch", type=int, default=16,
                    help="top batch-ladder rung")
    ap.add_argument("--rate", type=float, default=256.0,
                    help="per-model Poisson arrival rate (req/s)")
    ap.add_argument("--power-budget", type=float, default=None,
                    help="sustained power budget in W (enables "
                         "energy-aware dispatch)")
    ap.add_argument("--peak-w", type=float, default=None,
                    help="instantaneous power cap in W")
    ap.add_argument("--burst-j", type=float, default=0.0,
                    help="burst energy allowance in J per window")
    ap.add_argument("--window-s", type=float, default=10.0,
                    help="sliding accounting window in s")
    ap.add_argument("--clock", default="measured",
                    choices=["measured", "modeled"],
                    help="virtual-clock source: wall time per batch or the "
                         "plan's modeled latency (deterministic)")
    ap.add_argument("--pipeline", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="async pipelined dispatch: staging/compute/"
                         "readback overlap across batches")
    ap.add_argument("--staging-buffers", type=int, default=2,
                    help="host staging slots per (model, rung) = max "
                         "in-flight dispatches (2 = double buffering)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="skip the graph-compiler pass pipeline and serve "
                         "the op-by-op plans")
    ap.add_argument("--autotune", action="store_true",
                    help="plan-time kernel schedule search + prepacked "
                         "weight arenas; off = the heuristic schedule "
                         "(bit-identical outputs either way)")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="JSON tuning-cache path: a warm cache skips all "
                         "candidate evaluations across processes")
    ap.add_argument("--autotune-measure", action="store_true",
                    help="refine the autotuner's top-K picks by timing "
                         "those that launch different kernels on the card "
                         "(the conv's channel blocking); with --device cpu "
                         "no pick differs and nothing is timed")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.mode == "lm":
        return serve_lm_compiled(args)
    return serve_space(args)


if __name__ == "__main__":
    raise SystemExit(main())
