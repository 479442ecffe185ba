"""Eclipse-orbit serving driver — the power envelope through one orbit.

A LEO spacecraft's power budget is periodic: full solar input in
sunlight, a reduced bus allocation in penumbra, battery only in eclipse.
This example serves two instruments (the MMS plasma classifier and the
ESPERTA warning model) through ONE energy-budget-aware scheduler while
the envelope steps through a sunlight -> penumbra -> eclipse -> penumbra
-> sunlight cycle, pre-scheduled on the envelope exactly as a real ops
plan would be (the orbit is known in advance).

What to watch in the output:

* in sunlight the dispatcher favors the lowest-energy backend (the DPU
  analog for the classifier: high power, short draws, duty-cycled);
* entering eclipse the peak cap excludes the 6.75 W DPU outright and
  dispatch degrades gracefully to the cpu/flex fallbacks;
* nothing is ever dropped, and the envelope ledger audits to ZERO
  violations: admission-time checking makes that true by construction.

The virtual clock is the scheduler's ``modeled`` clock (plan-time cost
signatures of the paper's ZCU104 analog), so the timeline is
deterministic and the same on the card and on the CPU; the phase
durations are scaled to the models' modeled service times rather than
wall-clock orbit minutes.

Run:  PYTHONPATH=src python -m repro_torch.examples.eclipse_orbit
          [--requests 600] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from repro_torch.core.energy import PowerEnvelope
from repro_torch.core.engine import Engine
from repro_torch.core.radiation import ORBIT_PHASES, RadiationEnvironment
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        poisson_arrivals)
from repro_torch.models import SPACE_MODELS, synthetic_requests

USE_CASES = ("logistic_net", "multi_esperta")
BACKENDS = ("accel", "flex", "cpu")     # primary first; envelope fallbacks

# Per-phase power budget (sustained W, peak W). The phase NAMES and
# DURATIONS come from `core/radiation.py`'s canonical ORBIT_PHASES, so
# the radiation model's upset-rate modulation and this power envelope
# stay synced to the same orbit by construction.
_POWER: dict = {
    "sunlight": (6.0, float("inf")),
    "penumbra": (3.0, 7.0),
    "eclipse": (2.0, 3.0),              # peak 3 W: the 6.75 W DPU is out
}

# (phase, duration s, sustained W, peak W): one orbit, virtual seconds
PHASES: List[Tuple[str, float, float, float]] = [
    (phase, dur, *_POWER[phase]) for phase, dur in ORBIT_PHASES
]
WINDOW_S = 0.01


def build_envelope() -> Tuple[PowerEnvelope, List[Tuple[str, float]]]:
    env = PowerEnvelope(PHASES[0][2], peak_w=PHASES[0][3],
                        window_s=WINDOW_S)
    bounds, t = [], 0.0
    for phase, dur, sus, peak in PHASES:
        if t > 0:
            env.set_budget(t, sustained_w=sus, peak_w=peak)
        bounds.append((phase, t))
        t += dur
    return env, bounds + [("end", t)]


def run_orbit(n_requests: int, device=None,
              models: Optional[Dict[str, tuple]] = None) -> Dict:
    """Serve ``n_requests`` per instrument through one orbit and print the
    per-phase ledger. ``models`` maps a use case to ``(params,
    requests)`` replacing its seeded weights and requests. Returns the
    phase rows ``(phase, dispatches, backend mix, energy J, deferrals)``
    and the invariants."""
    env, bounds = build_envelope()
    orbit_s = bounds[-1][1]
    print("== one orbit under a stepped power envelope ==")
    for (phase, start), (_, end) in zip(bounds[:-1], bounds[1:]):
        _, _, sus, peak = PHASES[[b[1] for b in bounds].index(start)]
        cap = "-" if peak == float("inf") else f"{peak:.0f} W"
        print(f"  {start:5.2f}-{end:5.2f} s  {phase:9s} "
              f"sustained={sus:.0f} W  peak={cap}")
    renv = RadiationEnvironment()       # same ORBIT_PHASES by construction
    saa = renv.saa_window
    print(f"  radiation: GCR base {renv.base_rate:g} upsets/s "
          f"(eclipse x{dict(renv.phase_factors)['eclipse']:g}), SAA pass "
          f"{saa[0]:.2f}-{saa[1]:.2f} s x{renv.saa_factor:g} -> peak "
          f"{renv.rate_bound():g}/s")

    sched = ContinuousBatchingScheduler(envelope=env, clock="modeled")
    trace = []
    rate = n_requests / orbit_s
    for mi, name in enumerate(USE_CASES):
        m = SPACE_MODELS[name]
        params, reqs = (models or {}).get(name, (None, None))
        params = m.init_params(0) if params is None else params
        reqs = (synthetic_requests(m, n_requests, seed=1 + mi)
                if reqs is None else list(reqs)[:n_requests])
        engine = Engine(m.build_graph(), params, device=device)
        engine.calibrate(reqs[:4])
        sched.register(name, engine, backend=BACKENDS, warmup_sample=reqs[0])
        arrivals = poisson_arrivals(rate, n_requests, seed=mi)
        trace += [(t % orbit_s, name, r)      # wrap the poisson tail
                  for t, r in zip(arrivals, reqs)]

    end = sched.serve_trace(trace)
    print(f"\n[orbit] {len(trace)} requests over {orbit_s:.2f} s of orbit "
          f"(finished at {end:.3f} s virtual)")
    print(sched.summary())

    # per-phase backend mix + energy (dispatches bucketed by start time)
    print(f"\n{'phase':9s} {'disp':>5s} {'backend mix':28s} "
          f"{'energy J':>9s} {'defer':>6s}")
    rows = []
    for (phase, start), (_, stop) in zip(bounds[:-1], bounds[1:]):
        disps = [d for d in sched.dispatches if start <= d.started < stop]
        defers = sum(1 for r in sched.deferrals if start <= r.time < stop)
        mix: Dict[str, int] = {}
        for d in disps:
            mix[d.backend] = mix.get(d.backend, 0) + 1
        mix_s = " ".join(f"{b}:{c}" for b, c in sorted(mix.items())) or "-"
        e = sum(d.energy_j for d in disps)
        rows.append((phase, len(disps), mix_s, e, defers))
        print(f"{phase:9s} {len(disps):5d} {mix_s:28s} {e:9.4f} "
              f"{defers:6d}")

    rids = [c.rid for c in sched.completions]
    audit = sched.envelope_report()
    ok = (len(rids) == len(trace) and len(set(rids)) == len(rids)
          and audit["n_violations"] == 0)
    print(f"\n[invariants] served {len(set(rids))}/{len(trace)} exactly "
          f"once; envelope violations={audit['n_violations']}; "
          f"max window power={audit['max_window_w']:.2f} W  "
          f"-> {'OK' if ok else 'FAILED'}")
    return {"rows": rows, "end": end, "ok": ok, "served": len(set(rids)),
            "n_requests": len(trace), "audit": audit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=600,
                    help="requests per instrument across the orbit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    return 0 if run_orbit(args.requests, args.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
