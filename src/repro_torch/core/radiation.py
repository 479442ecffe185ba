"""Orbit-aware radiation environment (DESIGN.md §16).

The degraded-mode suite (§13) injects single-bit weight-arena upsets at
a *constant* Poisson rate. Real LEO missions see nothing of the sort:
the galactic-cosmic-ray (GCR) background is modulated by eclipse phase
(the ZCU104 analog runs hotter and lower-margin in sunlight, colder in
eclipse) and punctuated by South Atlantic Anomaly (SAA) passes where the
trapped-proton flux multiplies the upset rate by one to two orders of
magnitude for a few minutes per orbit. Upsets are also not all
single-bit: adjacent multi-bit bursts (MBUs) from a single heavy-ion
track and control-path upsets (scheduler ladder/queue state, staging
slots, the persisted TuningCache) need their own detection and recovery
story.

This module is the *environment* half of that story — pure numpy, no
jax, importable by both the fault controller and the examples:

- ``ORBIT_PHASES`` — the canonical eclipse phase schedule. This is the
  single source of truth that ``examples/eclipse_orbit.py`` zips with
  its power envelopes, so the radiation model and the power model stay
  synced by construction. Durations are *virtual* seconds at the same
  ~1000x time compression the examples use.
- ``RadiationEnvironment`` — a seedable, deterministic time-varying
  upset-rate model: base GCR rate x eclipse-phase factor x SAA-window
  multiplier, periodic in the orbit. Sampled into concrete schedules
  with non-homogeneous Poisson (NHPP) thinning: draw candidates from a
  homogeneous process at the rate *bound*, accept each with probability
  rate(t)/bound. Every accepted event draws an upset class from the
  configured mixture — 'single' (one flipped bit), 'mbu' (one flipped
  bit in each of ``span`` adjacent bytes), 'control' (a scheduler /
  staging / tuning-cache corruption).
- ``optimize_cadence`` — expected replay-loss + checkpoint-overhead
  cadence optimization against the environment's rate trace, validated
  by the radiation benchmark's modeled-clock watchdog-reboot replays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ORBIT_PHASES", "DEFAULT_PHASE_FACTORS", "DEFAULT_MIX",
    "CONTROL_TARGETS", "UpsetEvent", "RadiationEnvironment",
    "CadencePlan", "expected_replay_cost", "optimize_cadence",
]


# ---------------------------------------------------------------------------
# Canonical orbit phase schedule (shared with examples/eclipse_orbit.py)
# ---------------------------------------------------------------------------

# (phase name, duration in virtual seconds). One orbit = 0.50 virtual s
# at the examples' time compression (a real ~95 min LEO orbit).
ORBIT_PHASES: Tuple[Tuple[str, float], ...] = (
    ("sunlight", 0.15),
    ("penumbra", 0.05),
    ("eclipse", 0.15),
    ("penumbra", 0.05),
    ("sunlight", 0.10),
)

# GCR-background multipliers per eclipse phase. Eclipse-side passes run
# through the nightside horns of the outer belt, so the background
# creeps up; the effect is small next to an SAA pass.
DEFAULT_PHASE_FACTORS: Tuple[Tuple[str, float], ...] = (
    ("sunlight", 1.0),
    ("penumbra", 1.15),
    ("eclipse", 1.3),
)

# Upset-class mixture: P(single), P(mbu), P(control). Roughly the split
# reported for SRAM-based FPGAs — most upsets single-bit, a quarter
# adjacent multi-bit, a thin tail hitting configuration/control state.
DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("single", 0.60),
    ("mbu", 0.25),
    ("control", 0.15),
)

# Control-path subsystems the injector knows how to corrupt.
CONTROL_TARGETS: Tuple[str, ...] = ("ladder", "queue", "staging", "tuning")

UPSET_KINDS: Tuple[str, ...] = ("single", "mbu", "control")


@dataclasses.dataclass(frozen=True)
class UpsetEvent:
    """One scheduled upset: when, what class, and how wide.

    ``span`` is the MBU burst width in adjacent bytes (1 for 'single').
    ``target`` names the control subsystem for 'control' events; empty
    means the injector picks one.
    """
    t: float
    kind: str = "single"
    span: int = 1
    target: str = ""

    def __post_init__(self):
        if self.kind not in UPSET_KINDS:
            raise ValueError(f"unknown upset kind {self.kind!r}; "
                             f"expected one of {UPSET_KINDS}")
        if self.span < 1:
            raise ValueError(f"upset span must be >= 1, got {self.span}")
        if self.target and self.target not in CONTROL_TARGETS:
            raise ValueError(f"unknown control target {self.target!r}; "
                             f"expected one of {CONTROL_TARGETS}")


# ---------------------------------------------------------------------------
# The environment
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RadiationEnvironment:
    """Deterministic time-varying upset-rate model, periodic in the orbit.

    rate(t) = base_rate * phase_factor(phase_of(t)) * saa_factor if t is
    inside the SAA window (orbit-relative) else 1. Rates are upsets per
    *virtual* second — at the examples' ~1000x compression, 2.0/s here
    is a realistic few-per-hour on orbit.
    """
    base_rate: float = 2.0
    phases: Tuple[Tuple[str, float], ...] = ORBIT_PHASES
    phase_factors: Tuple[Tuple[str, float], ...] = DEFAULT_PHASE_FACTORS
    # SAA pass as an orbit-relative [start, end) window, or None.
    saa_window: Optional[Tuple[float, float]] = (0.20, 0.32)
    saa_factor: float = 40.0
    mix: Tuple[Tuple[str, float], ...] = DEFAULT_MIX
    mbu_span: Tuple[int, int] = (2, 8)      # inclusive adjacent-byte range
    control_targets: Tuple[str, ...] = CONTROL_TARGETS

    def __post_init__(self):
        if self.base_rate < 0.0:
            raise ValueError("base_rate must be >= 0")
        if not self.phases:
            raise ValueError("need at least one orbit phase")
        if any(d <= 0.0 for _, d in self.phases):
            raise ValueError("phase durations must be positive")
        factors = dict(self.phase_factors)
        for name, _ in self.phases:
            if name not in factors:
                raise ValueError(f"no phase factor for phase {name!r}")
        if any(f < 0.0 for f in factors.values()):
            raise ValueError("phase factors must be >= 0")
        if self.saa_window is not None:
            s, e = self.saa_window
            if not (0.0 <= s < e <= self.orbit_s + 1e-12):
                raise ValueError(
                    f"saa_window {self.saa_window} must satisfy "
                    f"0 <= start < end <= orbit_s ({self.orbit_s:g})")
        if self.saa_factor < 1.0:
            raise ValueError("saa_factor must be >= 1")
        if abs(sum(w for _, w in self.mix) - 1.0) > 1e-9:
            raise ValueError("upset-class mix weights must sum to 1")
        if any(k not in UPSET_KINDS for k, _ in self.mix):
            raise ValueError(f"mix kinds must be among {UPSET_KINDS}")
        if not (1 <= self.mbu_span[0] <= self.mbu_span[1]):
            raise ValueError(f"bad mbu_span {self.mbu_span}")

    # -- geometry ----------------------------------------------------------

    @property
    def orbit_s(self) -> float:
        return sum(d for _, d in self.phases)

    def phase_of(self, t: float) -> str:
        u = math.fmod(t, self.orbit_s)
        if u < 0.0:
            u += self.orbit_s
        acc = 0.0
        for name, dur in self.phases:
            acc += dur
            if u < acc:
                return name
        return self.phases[-1][0]

    def in_saa(self, t: float) -> bool:
        if self.saa_window is None:
            return False
        u = math.fmod(t, self.orbit_s)
        if u < 0.0:
            u += self.orbit_s
        s, e = self.saa_window
        return s <= u < e

    # -- rates -------------------------------------------------------------

    def rate(self, t: float) -> float:
        """Instantaneous upset rate (events / virtual s) at time t."""
        r = self.base_rate * dict(self.phase_factors)[self.phase_of(t)]
        if self.in_saa(t):
            r *= self.saa_factor
        return r

    def rate_bound(self) -> float:
        """A tight upper bound on rate(t) — the NHPP thinning envelope."""
        fmax = max(dict(self.phase_factors)[name] for name, _ in self.phases)
        bound = self.base_rate * fmax
        if self.saa_window is not None:
            bound *= self.saa_factor
        return bound

    def expected_upsets(self, t0: float, t1: float, dt: float = 1e-3) -> float:
        """Numerical integral of rate(t) over [t0, t1] (midpoint rule)."""
        if t1 <= t0:
            return 0.0
        n = max(1, int(math.ceil((t1 - t0) / dt)))
        step = (t1 - t0) / n
        return sum(self.rate(t0 + (i + 0.5) * step) for i in range(n)) * step

    def uncorrectable_fraction(self, n_domains: int) -> float:
        """Fraction of *arena* upsets SEC-per-domain ECC cannot correct.

        With byte-interleaved protection domains, a burst of span <=
        n_domains lands at most one byte per domain, so singles and
        short MBUs correct; only spans > n_domains are detect-only.
        Control-path upsets never touch the arena and are excluded.
        """
        mix = dict(self.mix)
        arena_w = mix.get("single", 0.0) + mix.get("mbu", 0.0)
        if arena_w <= 0.0:
            return 0.0
        lo, hi = self.mbu_span
        spans = hi - lo + 1
        n_bad = sum(1 for s in range(lo, hi + 1) if s > n_domains)
        return (mix.get("mbu", 0.0) * n_bad / spans) / arena_w

    # -- sampling ----------------------------------------------------------

    def sample_upsets(self, seed: int, horizon_s: float,
                      start: float = 0.0) -> Tuple[UpsetEvent, ...]:
        """Draw a concrete upset schedule over [start, start+horizon_s).

        NHPP thinning: homogeneous candidates at ``rate_bound()``, each
        accepted with probability rate(t)/bound. Class / span / target
        draws happen only for accepted candidates, so two environments
        that agree on rate() and mix produce the same schedule from the
        same seed. Deterministic per (seed, horizon, start).
        """
        bound = self.rate_bound()
        if bound <= 0.0 or horizon_s <= 0.0:
            return ()
        rng = np.random.default_rng(int(seed) + 17)
        mix_kinds = [k for k, _ in self.mix]
        mix_cdf = np.cumsum([w for _, w in self.mix])
        lo, hi = self.mbu_span
        out: List[UpsetEvent] = []
        t = start
        while True:
            t += rng.exponential(1.0 / bound)
            if t >= start + horizon_s:
                break
            if rng.uniform() * bound > self.rate(t):
                continue                     # thinned away
            kind = mix_kinds[int(np.searchsorted(mix_cdf, rng.uniform(),
                                                 side="right"))]
            span, target = 1, ""
            if kind == "mbu":
                span = int(rng.integers(lo, hi + 1))
            elif kind == "control":
                target = self.control_targets[
                    int(rng.integers(len(self.control_targets)))]
            out.append(UpsetEvent(float(t), kind, span, target))
        return tuple(out)


# ---------------------------------------------------------------------------
# Checkpoint-cadence optimization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CadencePlan:
    """The optimizer's pick plus the full cost curve it argmin'd over."""
    cadence_s: float
    expected_cost_s: float
    checkpoint_cost_s: float
    horizon_s: float
    n_checkpoints: int
    curve: Tuple[Tuple[float, float], ...]   # (cadence, expected cost)


def expected_replay_cost(env: RadiationEnvironment, horizon_s: float,
                         cadence_s: float, checkpoint_cost_s: float,
                         replay_factor: float = 1.0, start: float = 0.0,
                         dt: Optional[float] = None) -> float:
    """Expected virtual seconds lost to checkpointing + watchdog replay.

        cost(T) = ceil(H/T) * c_ckpt
                + replay_factor * integral rate(t) * ((t-start) mod T) dt

    The integrand is the expected rollback distance if a reboot-class
    upset lands at t: everything since the last checkpoint replays.
    ``replay_factor`` scales replay seconds into cost (1.0 = replayed
    work costs what it cost the first time).
    """
    if cadence_s <= 0.0 or horizon_s <= 0.0:
        raise ValueError("cadence_s and horizon_s must be positive")
    if checkpoint_cost_s < 0.0:
        raise ValueError("checkpoint_cost_s must be >= 0")
    n_ckpt = int(math.ceil(horizon_s / cadence_s))
    if dt is None:
        dt = min(horizon_s / 512.0, cadence_s / 8.0)
    n = max(1, int(math.ceil(horizon_s / dt)))
    step = horizon_s / n
    replay = 0.0
    for i in range(n):
        t = start + (i + 0.5) * step
        replay += env.rate(t) * math.fmod(t - start, cadence_s) * step
    return n_ckpt * checkpoint_cost_s + replay_factor * replay


def optimize_cadence(env: RadiationEnvironment, horizon_s: float,
                     checkpoint_cost_s: float, replay_factor: float = 1.0,
                     start: float = 0.0,
                     candidates: Optional[Sequence[float]] = None,
                     ) -> CadencePlan:
    """Pick the checkpoint cadence minimizing ``expected_replay_cost``.

    The curve is convex-ish in log T (overhead ~ 1/T, replay ~ T), so a
    geometric candidate grid brackets the minimum; the default grid
    spans from "checkpointing is half the budget" down to "one
    checkpoint for the whole horizon". Deterministic — no sampling.
    """
    if candidates is None:
        lo = max(2.0 * checkpoint_cost_s, horizon_s / 512.0)
        lo = min(lo, horizon_s)
        candidates = np.geomspace(lo, horizon_s, 41)
    curve = [(float(T), expected_replay_cost(env, horizon_s, float(T),
                                             checkpoint_cost_s,
                                             replay_factor, start))
             for T in candidates]
    best_T, best_cost = min(curve, key=lambda p: (p[1], p[0]))
    return CadencePlan(
        cadence_s=best_T, expected_cost_s=best_cost,
        checkpoint_cost_s=checkpoint_cost_s, horizon_s=horizon_s,
        n_checkpoints=int(math.ceil(horizon_s / best_T)),
        curve=tuple(curve))
