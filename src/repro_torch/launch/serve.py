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

``--fault-rate``/``--self-test-period`` (space mode) arm the
degraded-mode fault controller (``core/faults.py``): seeded SEU flips in
the accel weight arenas, golden-canary self-tests, and ``--recovery
repack|demote``. ``--radiation orbit`` samples a typed single/MBU/control
upset schedule from the orbit's rate trace instead (``core/radiation.py``;
``--base-upset-rate``, ``--saa-factor``, ``--protection none|ecc|tmr``,
``--checkpoint-cadence auto``). ``--checkpoint PATH`` restores the
scheduler ledger from PATH before serving when the file exists (the
watchdog-reboot path) and saves it after. Use ``--clock modeled`` for a
storm that replays identically on any device.

``--trace-demo`` (space mode) traces the depthwise-separable cloud-mask
CNN, a model with no hand-built graph, from its PyTorch function through
the ``torch.fx`` front-end (``frontend/demo.py``) and drives it trace ->
inspect -> PTQ -> autotune -> scheduler serve; it honours ``--requests``,
``--rate``, ``--batch``, ``--backend`` and ``--autotune``.

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
    PYTHONPATH=src python -m repro_torch.launch.serve --mode space \\
        --model logistic_net --backend accel,cpu --clock modeled \\
        --radiation orbit --protection ecc --checkpoint ledger.npz
    PYTHONPATH=src python -m repro_torch.launch.serve --trace-demo \
        --backend accel,flex --requests 32 --batch 8 --autotune
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core import inspector
from repro_torch.core import radiation as radiation_mod
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


def parse_backends(spec: str) -> tuple:
    """``--backend``'s comma list, primary first; a usage error names any
    unknown entry."""
    backends = tuple(b.strip() for b in spec.split(",") if b.strip())
    bad = [b for b in backends if b not in BACKENDS]
    if bad or not backends:
        raise SystemExit(f"unknown backend(s) {bad}; choose from "
                         f"{', '.join(BACKENDS)}")
    return backends


def autotune_options(args) -> dict:
    """The Engine's autotune keyword arguments from the launcher flags;
    ``--tuning-cache``/``--autotune-measure`` without ``--autotune`` is a
    usage error (they would be ignored silently otherwise)."""
    if (args.tuning_cache or args.autotune_measure) and not args.autotune:
        raise SystemExit("--tuning-cache/--autotune-measure configure the "
                         "plan-time autotuner; pass --autotune to enable it")
    return dict(autotune=args.autotune, tuning_cache=args.tuning_cache,
                autotune_measure=args.autotune_measure)


def fault_mode(args) -> bool:
    """Whether the flags arm the fault controller."""
    return (args.fault_rate > 0.0 or args.self_test_period is not None
            or args.radiation != "off")


def check_fault_flags(args, backends) -> None:
    """Usage errors for half-specified fault/radiation flag sets (they
    would be ignored silently otherwise)."""
    rad_mode = args.radiation != "off"
    rad_flags = (args.base_upset_rate is not None
                 or args.saa_factor is not None
                 or args.protection != "none"
                 or args.checkpoint_cadence is not None)
    if rad_flags and not rad_mode:
        raise SystemExit("--base-upset-rate/--saa-factor/--protection/"
                         "--checkpoint-cadence configure the orbital "
                         "radiation model; pass --radiation orbit to "
                         "enable it")
    faulted = fault_mode(args)
    if faulted and "accel" not in backends:
        raise SystemExit("--fault-rate/--self-test-period model SEUs in "
                         "the accel weight arenas; include 'accel' in "
                         "--backend")
    if faulted and args.recovery == "demote" and len(backends) < 2:
        raise SystemExit("--recovery demote quarantines the primary "
                         "backend; register a fallback (e.g. accel,cpu)")
    if (not faulted and (args.fault_seed != 0
                         or args.recovery != "repack")):
        raise SystemExit("--fault-seed/--recovery configure fault "
                         "injection; pass --fault-rate and/or "
                         "--self-test-period to enable it")


def build_scheduler(args) -> tuple:
    """Parse the model/backend lists, build and calibrate one engine per
    model, register each with the scheduler, and make the arrival trace.
    Returns ``(scheduler, trace, engines)``."""
    names = [n.strip() for n in args.model.split(",") if n.strip()]
    unknown = [n for n in names if n not in SPACE_MODELS]
    if unknown or not names:
        raise SystemExit(f"unknown model(s) {unknown}; choose from "
                         f"{', '.join(sorted(SPACE_MODELS))}")
    backends = parse_backends(args.backend)
    ladder = capped_ladder(args.batch)
    check_fault_flags(args, backends)

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


def arm_faults(args, sched, trace):
    """The fault controller the flags ask for, attached to ``sched`` and
    armed on every registered model with its first request as the canary
    (None when no fault flag is set). Under ``--radiation orbit`` the
    upset schedule is sampled over the trace's span plus 1 s."""
    if not fault_mode(args):
        return None
    horizon = max((t for t, _, _ in trace), default=0.0) + 1.0
    upsets: tuple = ()
    self_test = args.self_test_period
    if args.radiation != "off":
        renv = radiation_mod.RadiationEnvironment(
            base_rate=(2.0 if args.base_upset_rate is None
                       else args.base_upset_rate),
            saa_factor=(40.0 if args.saa_factor is None
                        else args.saa_factor))
        upsets = renv.sample_upsets(args.fault_seed, horizon)
        if self_test is None:
            self_test = 0.05        # canary detection for 'none' mode
        print(f"[radiation] orbit model: base={renv.base_rate:g}/s  "
              f"SAA x{renv.saa_factor:g} over "
              f"{renv.saa_window[0]:.2f}-{renv.saa_window[1]:.2f} s  "
              f"-> {len(upsets)} upset(s) sampled over {horizon:.2f} s"
              f"  protection={args.protection}")
        if args.checkpoint_cadence is not None:
            # price one ledger checkpoint at the modeled save cost (a
            # state_dict .npz is small; dominated by the host write)
            plan = radiation_mod.optimize_cadence(
                renv, horizon_s=horizon, checkpoint_cost_s=1e-3)
            print(f"[radiation] checkpoint cadence: T*="
                  f"{plan.cadence_s*1e3:.2f} ms "
                  f"({plan.n_checkpoints} checkpoints, expected "
                  f"replay+overhead {plan.expected_cost_s*1e3:.2f} ms "
                  f"over the horizon)")
    controller = faults_mod.FaultController(faults_mod.FaultConfig(
        seed=args.fault_seed, fault_rate=args.fault_rate,
        horizon_s=horizon if args.fault_rate > 0 else 0.0,
        self_test_period=self_test,
        recovery=args.recovery, upsets=upsets,
        protection=args.protection))
    sched.attach_faults(controller)
    first = {}
    for _, name, r in trace:
        first.setdefault(name, r)
    for name in sched.models:
        controller.arm(sched, name, [first[name]])
    print(f"[faults] armed {len(sched.models)} model(s): rate="
          f"{args.fault_rate}/s  self-test period="
          f"{self_test} s  recovery={args.recovery}")
    return controller


def serve_space(args) -> int:
    sched, trace, _ = build_scheduler(args)
    controller = arm_faults(args, sched, trace)
    if args.checkpoint and os.path.exists(args.checkpoint):
        # the watchdog-reboot path: a fresh process re-registers the same
        # models (pristine weights), then resumes the accepted-request
        # ledger from the checkpoint
        sched.load_state_dict(faults_mod.load_checkpoint(args.checkpoint))
        done = {c.rid for c in sched.completions}
        print(f"[checkpoint] restored {args.checkpoint}: "
              f"{len(done)} completed, {sched.pending()} queued")
        trace = []                 # the checkpoint owns the accepted queue
    t0 = time.perf_counter()
    end = sched.serve_trace(trace)
    wall = time.perf_counter() - t0
    print(f"[serve] {len(trace)} requests over {len(sched.models)} model(s)  "
          f"virtual={end:.3f} s  wall={wall:.3f} s")
    print(sched.summary())
    if controller is not None:
        rep = controller.report()
        print(f"[faults] injected={rep['n_injected']}  detected="
              f"{rep['n_detected']}  recovered={rep['n_recovered']}  "
              f"self-tests={rep['n_self_tests']}  overhead="
              f"{rep['overhead_energy_j']*1e3:.3f} mJ  max detection "
              f"latency={rep['max_detection_latency_s']*1e3:.2f} ms")
    if args.checkpoint:
        faults_mod.save_checkpoint(args.checkpoint, sched.state_dict())
        print(f"[checkpoint] saved {args.checkpoint}")
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


def trace_demo(args) -> int:
    """The torch.fx front-end demo: trace the cloud-mask CNN (never hand
    built) and serve it end to end; exit code 1 unless every request was
    served."""
    from repro_torch.frontend.demo import run_demo
    facts = run_demo(n_requests=args.requests, rate_hz=args.rate,
                     batch_top=args.batch, autotune=args.autotune,
                     backends=parse_backends(args.backend), verbose=True,
                     device=args.device)
    print(f"[trace-demo] {facts['n_completed']}/{facts['n_requests']} "
          f"served, {facts['n_kept']} kept for downlink "
          f"({facts['mac_coverage']:.1%} of MACs on accel, "
          f"{facts['n_segments']} segments)")
    return 0 if facts["n_completed"] == facts["n_requests"] else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="space", choices=["space", "lm"])
    ap.add_argument("--trace-demo", action="store_true",
                    help="torch.fx front-end demo: trace the depthwise-"
                         "separable cloud-mask CNN (never hand-built) and "
                         "serve it end to end; honours --requests/--rate/"
                         "--batch/--backend/--autotune")
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
    # degraded-mode fault injection + checkpointing (space mode)
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="SEU injection rate in faults per virtual "
                         "second (Poisson, seeded); flips bits in the "
                         "accel weight arenas")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the fault schedule and flip targets")
    ap.add_argument("--self-test-period", type=float, default=None,
                    metavar="S",
                    help="run an in-band golden-canary self-test per "
                         "model every S virtual seconds (low-priority "
                         "scheduler work; detects silent corruption)")
    ap.add_argument("--recovery", default="repack",
                    choices=["repack", "demote"],
                    help="on canary mismatch: re-pack arenas from "
                         "pristine host weights, or quarantine the "
                         "primary backend (dispatch falls back) until a "
                         "delayed repair")
    # orbit-aware radiation environment (space mode)
    ap.add_argument("--radiation", default="off", choices=["off", "orbit"],
                    help="orbit-aware upset model: sample a typed "
                         "single/MBU/control upset schedule from the "
                         "eclipse-phase + SAA rate trace (seeded by "
                         "--fault-seed) instead of / on top of the flat "
                         "--fault-rate Poisson storm")
    ap.add_argument("--base-upset-rate", type=float, default=None,
                    metavar="R",
                    help="GCR background upset rate in upsets per virtual "
                         "second (default 2.0)")
    ap.add_argument("--saa-factor", type=float, default=None, metavar="X",
                    help="South Atlantic Anomaly rate multiplier over the "
                         "orbit-relative SAA window (default 40)")
    ap.add_argument("--protection", default="none",
                    choices=["none", "ecc", "tmr"],
                    help="arena protection mode: canary-only detection, "
                         "SEC ECC per byte-interleaved domain (+12.5%% "
                         "footprint + scrub), or TMR (3x footprint, "
                         "upsets voted away)")
    ap.add_argument("--checkpoint-cadence", default=None, metavar="auto",
                    help="print the expected-replay-loss-optimal ledger "
                         "checkpoint cadence for the radiation "
                         "environment (pass 'auto')")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="scheduler-ledger checkpoint (.npz): restored "
                         "at startup if present (the watchdog-reboot "
                         "path — zero accepted requests lost), saved at "
                         "exit")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.trace_demo:
        return trace_demo(args)
    if args.mode == "lm":
        return serve_lm_compiled(args)
    return serve_space(args)


if __name__ == "__main__":
    raise SystemExit(main())
