"""Degraded-mode fault modeling: SEU injection, in-band self-test
detection, and the recovery ladder (DESIGN.md §13), for the PyTorch port.

Radiation-induced single-event upsets (SEUs) are the dominant on-orbit
failure mode the deployment literature centers on (PAPERS.md: the FPGA
space-accelerator survey and the CubeSat cloud-detection design). The
repo already holds every mechanism a detect -> recover -> resume story
needs — prepacked int8 weight arenas (live, argument-fed buffers on the
compiled plans), golden output digests, modeled cost signatures, and
multi-backend registration — and this module connects them:

* :class:`SEUInjector` — deterministic, seedable bit flips in a plan's
  live :attr:`~repro_torch.core.plan.ExecutionPlan.weight_arena` (the
  modeled DPU weight memory: a dict of int8 tensors on the plan's
  device). Plans read the arena dict on every call, so a flip corrupts
  every subsequent dispatch on that backend without any re-lowering —
  exactly the silent-corruption regime an SEU creates. A flip takes a
  host copy of the entry, XORs the bits, and REPLACES the dict entry
  with a fresh device tensor: a dispatch still in flight keeps reading
  the old tensor, which the stream-ordered allocator frees only after
  it. Flips into host *staging* buffers (pinned tensors) are also
  supported; they are transient by construction (``stage()`` rewrites
  every row).
* :class:`GoldenCanary` — one fixed canary batch per armed model, run
  once at arm time against pristine weights to pin a sha256 output
  digest (the serve-time analog of ``tests/golden/``). A self-test
  re-runs the canary and compares digests — bit-exact or corrupt, no
  tolerance band, because the int8 plans are deterministic (split-K's
  cross-block sums are integer atomics, which are order-free).
* :class:`FaultController` — the watchdog: injects scheduled faults,
  runs periodic self-tests as LOW-PRIORITY scheduler work (deferred
  while the model's queue is busy, aged in after half a period so
  detection latency stays bounded), prices every test and recovery on
  the virtual clock and the energy ledger, and drives the recovery
  ladder — ``repack`` (restore the arena from pristine host copies,
  re-verify) or ``demote`` (quarantine the primary backend so dispatch
  falls back through the existing multi-backend registration, repair and
  un-quarantine after a watchdog delay). A cost-signature drift report
  (EWMA service estimates vs plan-time modeled latencies) provides the
  complementary always-on detection signal.
* :func:`save_checkpoint` / :func:`load_checkpoint` — the scheduler
  ledger (``state_dict()``) as a single ``.npz``: JSON metadata with
  every ndarray lifted into named entries (``allow_pickle=False`` on
  both sides), so a simulated watchdog reboot restores the accepted
  queues, EWMA state, RNG, and telemetry records and loses zero
  accepted requests.

An unarmed / inert controller (no faults, no self-test period) leaves
``serve_trace`` dispatch-for-dispatch identical to running without one.

The radiation layer (DESIGN.md §16) widens all of this beyond constant-
rate single-bit flips. ``core/radiation.py`` supplies orbit-correlated
:class:`~repro_torch.core.radiation.UpsetEvent` schedules with an upset-class
mixture, and this module handles each class end to end:

* **'single'** — the §13 path: one flipped bit, canary detection,
  repack/demote recovery.
* **'mbu'** — adjacent multi-bit bursts (:meth:`SEUInjector.flip_mbu`):
  one flipped bit in each of ``span`` consecutive bytes. Same canary
  detection; under ECC the burst is correctable iff the interleaved
  protection-domain plan keeps it to one byte per domain.
* **'control'** — upsets OUTSIDE the weight arena: the scheduler's EWMA
  service ladder, a queued request's deadline, a host staging slot, or
  the persisted ``TuningCache`` file. Canaries cannot see these, so the
  controller runs periodic structural self-checks (invariant sweeps) on
  the self-test cadence and restores corrupt control state from an
  internally held ``state_dict()``-style shadow snapshot.

Always-on arena protection is priced, not assumed: ``FaultConfig(
protection='ecc'|'tmr')`` re-prices the armed model's cost signatures
through `energy.protected_signature` (ECC decode drag + scrub power;
TMR footprint/power tripling + vote latency) and schedules periodic
scrub passes; :func:`choose_protection` is the dispatcher-side J/inf
table that trades canary self-test budget against that standing cost as
the orbit's upset rate swings (quiet GCR background vs an SAA pass).

Every cost here is the paper's ZCU104 analog model (``core/energy.py``):
modeled seconds and joules on the virtual clock, not the card's time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import energy as energy_mod
from repro_torch.core import memory as memory_mod
from repro_torch.core.radiation import CONTROL_TARGETS, UpsetEvent

_CANARY_KEY = 20260801          # fixed canary rng: digests must be stable
# the canary's raw seed pair: the key data of PRNGKey(_CANARY_KEY)
_CANARY_SEED = np.array([0, _CANARY_KEY], np.uint32)
_ARRAY_TAG = "__array__:"


def _arena_bytes(plan) -> int:
    return sum(a.nbytes for a in plan.weight_arena.values())


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------


def output_digest(outputs: Dict[str, np.ndarray]) -> str:
    """sha256 over (key, shape, dtype, bytes) of every output, sorted by
    key — the bit-exact fingerprint self-tests compare."""
    h = hashlib.sha256()
    for k in sorted(outputs):
        a = np.ascontiguousarray(np.asarray(outputs[k]))
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# SEU injection
# ---------------------------------------------------------------------------


class SEUInjector:
    """Deterministic seeded single-bit flips in live weight arenas.

    Target selection is weighted by buffer size (a physical SEU is
    equally likely per bit of exposed memory); explicit ``node`` /
    ``byte`` / ``bit`` pin the flip for regression tests."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.n_flips = 0

    def _pick_node(self, arena, node: Optional[str]) -> str:
        """``node``, or one drawn with probability proportional to its
        entry's bytes."""
        if node is not None:
            return node
        names = sorted(arena)
        sizes = np.array([arena[n].nbytes for n in names],
                         dtype=np.float64)
        return names[int(self._rng.choice(len(names),
                                          p=sizes / sizes.sum()))]

    def flip(self, plan, node: Optional[str] = None,
             byte: Optional[int] = None, bit: Optional[int] = None
             ) -> Tuple[str, int, int]:
        """Flip one bit of one weight-arena entry of ``plan``: the entry
        is replaced by a host round-tripped copy with the bit XORed.
        Returns (node, byte offset, bit index)."""
        arena = plan.weight_arena
        if not arena:
            raise ValueError(
                f"plan {plan.graph.name}/{plan.backend} has no quantized "
                f"weight arena to inject into")
        node = self._pick_node(arena, node)
        arr = arena[node].cpu().numpy().copy()
        flat = arr.view(np.uint8).reshape(-1)
        if byte is None:
            byte = int(self._rng.integers(flat.size))
        if bit is None:
            bit = int(self._rng.integers(8))
        flat[byte] ^= np.uint8(1 << bit)
        arena[node] = torch.from_numpy(arr).to(plan.device)
        self.n_flips += 1
        return node, byte, bit

    def flip_mbu(self, plan, span: int, node: Optional[str] = None,
                 byte: Optional[int] = None) -> Tuple[str, int, int]:
        """Adjacent multi-bit burst: flip one bit in each of ``span``
        CONSECUTIVE bytes of one weight-arena entry (a single heavy-ion
        track clipping a row of cells). The burst is clamped to the
        entry, so it never wraps across arena entries — which is what
        makes byte-interleaved ECC domains effective against it.
        Returns (node, first byte offset, span actually flipped)."""
        if span < 1:
            raise ValueError(f"MBU span must be >= 1, got {span}")
        arena = plan.weight_arena
        if not arena:
            raise ValueError(
                f"plan {plan.graph.name}/{plan.backend} has no quantized "
                f"weight arena to inject into")
        node = self._pick_node(arena, node)
        arr = arena[node].cpu().numpy().copy()
        flat = arr.view(np.uint8).reshape(-1)
        span = min(int(span), flat.size)
        if byte is None:
            byte = int(self._rng.integers(flat.size - span + 1))
        byte = min(int(byte), flat.size - span)
        for i in range(span):
            flat[byte + i] ^= np.uint8(1 << int(self._rng.integers(8)))
        arena[node] = torch.from_numpy(arr).to(plan.device)
        self.n_flips += span
        return node, byte, span

    def flip_staging(self, arena, slot: int = 0) -> Tuple[str, int, int]:
        """Flip one bit in a host staging buffer, in place through the
        pinned tensor's numpy view (transient corruption: ``stage()``
        rewrites every row of every buffer, so the flip only matters if
        it lands between staging and dispatch)."""
        bufs = arena._bufs[slot]
        name = sorted(bufs)[int(self._rng.integers(len(bufs)))]
        flat = bufs[name].numpy().view(np.uint8).reshape(-1)
        byte = int(self._rng.integers(flat.size))
        bit = int(self._rng.integers(8))
        flat[byte] ^= np.uint8(1 << bit)
        self.n_flips += 1
        return name, byte, bit


# ---------------------------------------------------------------------------
# Canaries
# ---------------------------------------------------------------------------


class GoldenCanary:
    """One in-band self-test unit: a fixed canary batch through one
    (model, backend, bottom-rung) pipeline, digest pinned at arm time."""

    def __init__(self, name: str, pipeline,
                 reqs: Sequence[Dict[str, np.ndarray]]):
        self.name = name
        self.pipeline = pipeline
        self.reqs = list(reqs)
        self.cost = pipeline.cost           # modeled canary dispatch cost
        self.digest, self.reference = self._snapshot()

    def _snapshot(self) -> Tuple[str, Dict[str, np.ndarray]]:
        out = self.run()
        return output_digest(out), out

    def run(self) -> Dict[str, np.ndarray]:
        res = self.pipeline.execute_batch(self.reqs, rng=_CANARY_SEED)
        return res.outputs

    def check(self) -> Tuple[bool, str]:
        """(passed, observed digest). Bit-exact comparison — any mismatch
        is corruption, by the int8 plans' determinism contract."""
        got = output_digest(self.run())
        return got == self.digest, got


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-storm shape. In precedence order: ``upsets`` pins a typed
    orbit-aware schedule (what ``RadiationEnvironment.sample_upsets``
    produces — mixed single/MBU/control classes); ``fault_times`` pins
    plain single-bit injections (deterministic storms, the §13 benchmark
    gates); otherwise a Poisson schedule at ``fault_rate`` over
    ``horizon_s`` is derived from ``seed``. ``self_test_period=None``
    disables periodic canaries AND the control-path structural checks
    that ride the same cadence (the inert controller the identity gate
    pins). ``protection`` prices always-on arena hardening (DESIGN.md
    §16) into the armed models' cost signatures and schedules scrubs."""
    seed: int = 0
    fault_times: Tuple[float, ...] = ()
    fault_rate: float = 0.0             # faults / virtual second
    horizon_s: float = 0.0
    self_test_period: Optional[float] = None
    recovery: str = "repack"            # 'repack' | 'demote'
    repair_delay_s: float = 0.05        # demote: watchdog repair latency
    aging_fraction: float = 0.5         # run a busy-deferred test once
                                        # overdue by this fraction of the
                                        # period (bounds detection lag)
    upsets: Tuple[UpsetEvent, ...] = ()  # typed orbit-aware schedule
    protection: str = "none"            # 'none' (canary-only) | 'ecc' | 'tmr'
    scrub_period_s: float = 0.05        # ECC/TMR background scrub cadence
    interleave_domains: int = 4         # ECC domains, byte-interleaved:
                                        # an MBU of span <= this corrects

    def __post_init__(self):
        if self.recovery not in ("repack", "demote"):
            raise ValueError(
                f"recovery must be repack|demote, got {self.recovery!r}")
        if self.protection not in energy_mod.PROTECTION_MODES:
            raise ValueError(
                f"protection must be one of "
                f"{energy_mod.PROTECTION_MODES}, got {self.protection!r}")
        if self.fault_rate < 0.0:
            raise ValueError(f"fault_rate must be >= 0, "
                             f"got {self.fault_rate}")
        if self.horizon_s < 0.0:
            raise ValueError(f"horizon_s must be >= 0, "
                             f"got {self.horizon_s}")
        if self.scrub_period_s <= 0.0:
            raise ValueError(f"scrub_period_s must be > 0, "
                             f"got {self.scrub_period_s}")
        if self.interleave_domains < 1:
            raise ValueError(f"interleave_domains must be >= 1, "
                             f"got {self.interleave_domains}")
        object.__setattr__(self, "fault_times", tuple(self.fault_times))
        object.__setattr__(self, "upsets", tuple(self.upsets))
        # a half-specified Poisson storm used to yield a silently empty
        # schedule; name the missing field instead
        if not self.fault_times and not self.upsets:
            if self.fault_rate > 0.0 and self.horizon_s <= 0.0:
                raise ValueError(
                    f"FaultConfig: fault_rate={self.fault_rate:g} > 0 "
                    f"but horizon_s == 0, so the Poisson schedule would "
                    f"be silently empty — set the missing field "
                    f"'horizon_s' to the virtual-time span the storm "
                    f"should cover")
            if self.horizon_s > 0.0 and self.fault_rate <= 0.0:
                raise ValueError(
                    f"FaultConfig: horizon_s={self.horizon_s:g} > 0 but "
                    f"fault_rate == 0, so the Poisson schedule would be "
                    f"silently empty — set the missing field "
                    f"'fault_rate' (faults / virtual second), or drop "
                    f"horizon_s")

    def schedule(self) -> List[float]:
        if self.fault_times:
            return sorted(float(t) for t in self.fault_times)
        if self.fault_rate <= 0.0 or self.horizon_s <= 0.0:
            return []
        rng = np.random.default_rng(self.seed + 1)
        times, t = [], 0.0
        while True:
            t += float(rng.exponential(1.0 / self.fault_rate))
            if t >= self.horizon_s:
                return times
            times.append(t)

    def upset_schedule(self) -> List[UpsetEvent]:
        """The typed schedule the controller consumes: explicit
        ``upsets`` when given, else every ``schedule()`` time as a
        single-bit upset (the §13 behavior, unchanged)."""
        if self.upsets:
            return sorted(self.upsets, key=lambda ev: ev.t)
        return [UpsetEvent(t) for t in self.schedule()]


@dataclasses.dataclass
class FaultEvent:
    """One injected upset's lifecycle in the controller's ledger.

    ``kind`` / ``span`` / ``target`` carry the radiation layer's upset
    class (DESIGN.md §16); the §13 single-bit defaults keep old ledgers
    readable. ``action`` records how it closed: 'repack' /
    'demote+repack' (canary-detected arena faults), 'ecc-correct' /
    'tmr-mask' (protection absorbed it at injection), 'scrub+repack'
    (ECC-uncorrectable burst caught by the background scrub),
    'control-restore' / 'control-rebuild' / 'control-rewrite' /
    'control-selfheal' (structural check repaired — or verified already
    overwritten — scheduler/tuning state), 'transient' (staging flip,
    overwritten by the next stage())."""
    t_injected: float
    model: str
    node: str
    byte: int
    bit: int
    detected_at: Optional[float] = None
    recovered_at: Optional[float] = None
    action: str = ""
    kind: str = "single"                # 'single' | 'mbu' | 'control'
    span: int = 1                       # MBU adjacent-byte burst width
    target: str = ""                    # control subsystem hit

    @property
    def detection_latency_s(self) -> Optional[float]:
        return (None if self.detected_at is None
                else self.detected_at - self.t_injected)


@dataclasses.dataclass
class _ArmedModel:
    name: str
    backend: str                        # primary (faultable) backend
    canary: GoldenCanary
    plan: Any                           # the primary backend ExecutionPlan
    next_test: Optional[float]
    repair_at: Optional[float] = None   # pending demote repair
    next_scrub: Optional[float] = None  # ECC/TMR background scrub timer
    protection_cost: Any = None         # energy.ProtectionCost when armed
                                        # under protection != 'none'
    domains: Any = None                 # memory.ProtectionDomainPlan (ECC
                                        # MBU correctability)


class FaultController:
    """The degraded-mode watchdog ``serve_trace`` ticks every scheduling
    round (see module docstring for the full protocol)."""

    # modeled cost of one structural control-state sweep (per armed
    # model): a CPU-side invariant walk over the ladder, the queues, and
    # the tuning cache — small next to a canary dispatch
    CONTROL_CHECK_S = 2e-5

    def __init__(self, config: FaultConfig):
        self.config = config
        self.injector = SEUInjector(config.seed)
        self._models: Dict[str, _ArmedModel] = {}
        self._pending: List[UpsetEvent] = config.upset_schedule()
        self.events: List[FaultEvent] = []
        self.energy_j = 0.0                 # self-tests + recoveries
        self.n_self_tests = 0
        self.n_recoveries = 0
        # radiation-layer telemetry (DESIGN.md §16)
        self.n_control_checks = 0
        self.n_scrubs = 0
        self.n_corrected = 0                # ECC-corrected + TMR-masked
        self._next_control_check: Optional[float] = None
        self._shadow: Dict[str, Dict[str, Any]] = {}   # control snapshots
        self._tuning_cache = None

    # -- arming --------------------------------------------------------------

    def arm(self, sched, name: str,
            canary_reqs: Sequence[Dict[str, np.ndarray]]) -> None:
        """Arm one registered model: pin its pristine canary digest on
        the primary backend's bottom rung. Must run BEFORE any fault can
        fire (the digest is the recovery reference).

        Under ``protection != 'none'`` this also applies the protected
        cost signatures to the model's primary backend (through
        ``sched.apply_protection``), plans the arena's byte-interleaved
        ECC domains, and starts the background scrub timer; and it
        snapshots the model's control state as the structural checks'
        restore point."""
        svc = sched._svcs[name]
        backend = svc.backends[0]
        rung = svc.ladder[0]
        pipe = svc.pipelines[backend][rung]
        reqs = (list(canary_reqs) * rung)[:rung]
        canary = GoldenCanary(name, pipe, reqs)
        period = self.config.self_test_period
        am = _ArmedModel(
            name=name, backend=backend, canary=canary,
            plan=pipe._plan.plan,
            next_test=None if period is None else period)
        prot = self.config.protection
        arena_bytes = _arena_bytes(am.plan)
        if prot != "none" and arena_bytes > 0:
            am.domains = memory_mod.plan_protection_domains(
                arena_bytes, self.config.interleave_domains)
            hw = energy_mod.BACKEND_HW[backend]
            am.protection_cost = energy_mod.protection_cost(
                hw, arena_bytes, prot, self.config.scrub_period_s)
            sched.apply_protection(name, prot, {
                (backend, r): energy_mod.protected_signature(
                    svc.costs[(backend, r)], hw, am.protection_cost)
                for r in svc.ladder})
            am.next_scrub = self.config.scrub_period_s
        self._models[name] = am
        self._shadow[name] = self._control_snapshot(svc)
        if period is not None and self._next_control_check is None:
            self._next_control_check = period

    def attach_tuning_cache(self, cache) -> None:
        """Register a persisted :class:`~repro_torch.core.autotune.TuningCache`
        as a control-path fault target: 'tuning' upsets corrupt its file
        on disk, and the structural check validates/rewrites it."""
        self._tuning_cache = cache

    # -- the serve_trace hooks ----------------------------------------------

    def tick(self, sched, now: float) -> float:
        """One watchdog round at virtual time ``now``: inject due
        upsets (instantaneous), run due repairs, due background scrubs,
        due self-tests, and the due control-state structural check —
        each test/scrub/recovery advances and returns the clock."""
        while self._pending and self._pending[0].t <= now + 1e-12:
            self._inject(sched, self._pending.pop(0))
        for am in self._models.values():
            if am.repair_at is not None and am.repair_at <= now + 1e-12:
                now = self._repair(sched, am, now)
        for am in self._models.values():
            if am.next_scrub is not None and am.next_scrub <= now + 1e-12:
                now = self._scrub(am, now)
                am.next_scrub = now + self.config.scrub_period_s
        period = self.config.self_test_period
        if period is None:
            return now
        for am in self._models.values():
            if am.next_test is None or am.repair_at is not None:
                continue                # known-bad: the repair timer owns it
            if am.next_test > now + 1e-12:
                continue
            overdue = now - am.next_test
            busy = sched._svcs[am.name].pick(now) is not None
            if busy and overdue < self.config.aging_fraction * period:
                continue                # low priority: real work first
            now = self._self_test(sched, am, now)
            am.next_test = now + period
        if (self._next_control_check is not None
                and self._next_control_check <= now + 1e-12):
            now = self._control_check(sched, now)
            self._next_control_check = now + period
        return now

    def next_event_time(self, now: float) -> Optional[float]:
        """Earliest pending watchdog instant — what an idle virtual
        clock jumps to (so self-tests run on schedule between bursts)."""
        times = [ev.t for ev in self._pending]
        if self._next_control_check is not None:
            times.append(self._next_control_check)
        for am in self._models.values():
            if am.next_scrub is not None:
                times.append(am.next_scrub)
            if am.repair_at is not None:
                times.append(am.repair_at)
            elif am.next_test is not None:
                times.append(am.next_test)
        future = [t for t in times if t > now + 1e-12]
        return min(future) if future else None

    def finalize(self, sched, now: float) -> float:
        """End-of-stream closing sweep: one scrub (where protected) and
        one self-test per armed model, plus one structural control
        check, so nothing injected during the final period escapes the
        ledger. A fully inert controller (no faults, no period, no
        protection) does nothing."""
        if (not self.events and self.config.self_test_period is None
                and self._next_control_check is None
                and all(am.next_scrub is None
                        for am in self._models.values())):
            return now
        for am in self._models.values():
            if am.repair_at is not None:
                now = self._repair(sched, am, max(now, am.repair_at))
            if am.next_scrub is not None:
                now = self._scrub(am, now)
                am.next_scrub = now + self.config.scrub_period_s
            now = self._self_test(sched, am, now)
            if am.next_test is not None:
                am.next_test = now + self.config.self_test_period
        open_control = any(e.kind == "control" and e.recovered_at is None
                           for e in self.events)
        if self._next_control_check is not None or open_control:
            now = self._control_check(sched, now)
            if self._next_control_check is not None:
                self._next_control_check = (
                    now + self.config.self_test_period)
        return now

    # -- fault lifecycle -----------------------------------------------------

    def _inject(self, sched, ev: UpsetEvent) -> None:
        """Land one due upset. Arena classes ('single'/'mbu') go through
        the protection stack: TMR masks everything (majority vote),
        interleaved-domain ECC corrects on access anything that puts at
        most one byte per domain, and what remains corrupts the live
        arena for the canary (or, under ECC, the scrub) to catch.
        'control' upsets corrupt scheduler / staging / tuning state."""
        if ev.kind == "control":
            self._inject_control(sched, ev)
            return
        targets = [am for am in self._models.values()
                   if am.plan.weight_arena]
        if not targets:
            raise RuntimeError(
                f"fault due at t={ev.t:.4f}s but no armed model has a "
                f"weight arena; arm() accel models before serving")
        sizes = np.array([_arena_bytes(am.plan) for am in targets],
                         dtype=np.float64)
        am = targets[int(self.injector._rng.choice(
            len(targets), p=sizes / sizes.sum()))]
        prot = self.config.protection
        if prot == "tmr" and am.protection_cost is not None:
            # two pristine copies outvote the hit copy on every access;
            # the periodic scrub resyncs the diverged copy in background
            self.events.append(FaultEvent(
                ev.t, am.name, node="(tmr-masked)", byte=-1, bit=-1,
                detected_at=ev.t, recovered_at=ev.t, action="tmr-mask",
                kind=ev.kind, span=ev.span))
            self.n_corrected += 1
            return
        if (prot == "ecc" and am.domains is not None
                and am.domains.correctable(ev.span)):
            # <= 1 corrupted byte per interleaved domain: SEC corrects
            # on the next access; the ledger stamps it at injection
            self.events.append(FaultEvent(
                ev.t, am.name, node="(ecc-corrected)", byte=-1, bit=-1,
                detected_at=ev.t, recovered_at=ev.t, action="ecc-correct",
                kind=ev.kind, span=ev.span))
            self.n_corrected += 1
            return
        # raw corruption: unprotected, or an ECC-uncorrectable burst
        # (span wider than the domain interleave — detect-only)
        if ev.kind == "mbu":
            node, byte, span = self.injector.flip_mbu(am.plan, ev.span)
            self.events.append(FaultEvent(
                ev.t, am.name, node, byte, bit=-1, kind="mbu", span=span))
        else:
            node, byte, bit = self.injector.flip(am.plan)
            self.events.append(FaultEvent(ev.t, am.name, node, byte, bit))

    def _inject_control(self, sched, ev: UpsetEvent) -> None:
        """Corrupt control-path state: the EWMA service ladder, a queued
        request's deadline, a host staging slot, or the persisted tuning
        cache. Targets that do not exist right now (empty queue, no
        staged buffers, no cache file) fall back to 'ladder' so the
        scheduled upset always lands somewhere real."""
        rng = self.injector._rng
        target = ev.target or CONTROL_TARGETS[
            int(rng.integers(len(CONTROL_TARGETS)))]
        names = sorted(self._models)
        if not names:
            raise RuntimeError(
                f"control fault due at t={ev.t:.4f}s but no model is "
                f"armed; arm() models before serving")
        name = names[int(rng.integers(len(names)))]
        am = self._models[name]
        svc = sched._svcs[name]
        if target == "queue" and not svc.queue:
            target = "ladder"
        if target == "staging":
            pipe = svc.pipelines[am.backend][svc.ladder[0]]
            if not pipe.arena._bufs[0]:
                target = "ladder"
        if target == "tuning":
            cache = self._tuning_cache
            if (cache is None or not getattr(cache, "path", None)
                    or not os.path.exists(cache.path)):
                target = "ladder"

        if target == "ladder":
            keys = sorted(svc.est_service)
            b, r = keys[int(rng.integers(len(keys)))]
            # a high-exponent-bit flip: the estimate explodes, the flush
            # margin with it — batching degrades until the check restores
            svc.est_service[(b, r)] = (
                svc.est_service[(b, r)] * float(2 ** 40))
            self.events.append(FaultEvent(
                ev.t, name, node=f"est_service[{b}/b{r}]", byte=-1,
                bit=-1, kind="control", target="ladder"))
        elif target == "queue":
            idx = int(rng.integers(len(svc.queue)))
            req = svc.queue[idx]
            svc.queue[idx] = dataclasses.replace(
                req, deadline=req.deadline * float(2 ** 40))
            self.events.append(FaultEvent(
                ev.t, name, node=f"queue[rid={req.rid}].deadline",
                byte=-1, bit=-1, kind="control", target="queue"))
        elif target == "staging":
            pipe = svc.pipelines[am.backend][svc.ladder[0]]
            buf, byte, bit = self.injector.flip_staging(pipe.arena)
            # transient by construction: stage() rewrites every row
            # before the next dispatch reads the slot
            self.events.append(FaultEvent(
                ev.t, name, node=f"staging[{buf}]", byte=byte, bit=bit,
                detected_at=ev.t, recovered_at=ev.t, action="transient",
                kind="control", target="staging"))
        else:                                   # tuning
            cache = self._tuning_cache
            with open(cache.path, "rb") as f:
                raw = bytearray(f.read())
            byte = int(rng.integers(len(raw)))
            raw[byte] ^= 1 << int(rng.integers(8))
            with open(cache.path, "wb") as f:
                f.write(bytes(raw))
            self.events.append(FaultEvent(
                ev.t, name, node=f"tuning_cache[{cache.path}]",
                byte=byte, bit=-1, kind="control", target="tuning"))

    @staticmethod
    def _control_snapshot(svc) -> Dict[str, Any]:
        """The structural checks' restore point for one model: the EWMA
        ladder state (what a control upset can silently corrupt and a
        queue rebuild can't re-derive). Refreshed after every passing
        check so measured-clock estimates stay current."""
        return {"est_service": dict(svc.est_service),
                "seeded": set(svc._seeded)}

    def _close_control_events(self, model: Optional[str], target: str,
                              now: float, action: str) -> None:
        for ev in self.events:
            if (ev.kind == "control" and ev.target == target
                    and (model is None or ev.model == model)
                    and ev.recovered_at is None):
                if ev.detected_at is None:
                    ev.detected_at = now
                ev.recovered_at = now
                ev.action = action

    # estimates this far off the modeled signature are structural
    # corruption, not drift: the injected exponent flip is ~2^40, the
    # widest honest measured-vs-modeled scale gap is orders below this
    _EST_BAND = 1e6

    def _control_check(self, sched, now: float) -> float:
        """One structural sweep over every armed model's control state:
        ladder estimates finite/positive/within the plausibility band
        (else restored from the shadow snapshot), queue deadlines
        reconstructible as arrival + deadline_s (else rebuilt), and the
        persisted tuning cache valid JSON of the current schema (else
        rewritten from the in-memory entries). Prices one CPU sweep on
        the clock and the energy ledger; refreshes the shadow from the
        now-verified state."""
        self.n_control_checks += 1
        hw = energy_mod.BACKEND_HW["cpu"]
        dt = self.CONTROL_CHECK_S * max(1, len(self._models))
        self.energy_j += hw.power_busy * dt
        now += dt
        for name, am in self._models.items():
            svc = sched._svcs[name]
            shadow = self._shadow.get(name)
            bad = [k for k, est in svc.est_service.items()
                   if not np.isfinite(est) or est <= 0.0
                   or (svc.costs[k].latency_s > 0.0
                       and not (svc.costs[k].latency_s / self._EST_BAND
                                <= est
                                <= svc.costs[k].latency_s * self._EST_BAND))]
            if bad and shadow is not None:
                svc.est_service = dict(shadow["est_service"])
                svc._seeded = set(shadow["seeded"])
            # open ladder events close either way: restored from the
            # shadow, or verified already overwritten by later EWMA
            # observations (the corrupt value retired out of the system)
            self._close_control_events(
                name, "ladder", now,
                "control-restore" if bad else "control-selfheal")
            rebuilt = False
            for idx, req in enumerate(svc.queue):
                want = req.arrival + svc.deadline_s
                if (not np.isfinite(req.deadline)
                        or abs(req.deadline - want) > 1e-9):
                    svc.queue[idx] = dataclasses.replace(
                        req, deadline=want)
                    rebuilt = True
            self._close_control_events(
                name, "queue", now,
                "control-rebuild" if rebuilt else "control-selfheal")
            self._shadow[name] = self._control_snapshot(svc)
        cache = self._tuning_cache
        if (cache is not None and getattr(cache, "path", None)
                and os.path.exists(cache.path)):
            ok = True
            try:
                with open(cache.path, "r", encoding="utf-8") as f:
                    payload = json.load(f)
                ok = (isinstance(payload, dict)
                      and isinstance(payload.get("entries"), dict))
            except (OSError, ValueError):
                ok = False
            if not ok:
                # the in-memory entries are authoritative: rewrite the
                # file through the cache's own atomic save path
                cache._dirty = True
                cache.save()
            self._close_control_events(
                None, "tuning", now,
                "control-rewrite" if not ok else "control-selfheal")
        return now

    def _scrub(self, am: _ArmedModel, now: float) -> float:
        """One background scrub pass over the protected arena: price the
        sweep, then repair what it found — under ECC an uncorrectable
        burst (span wider than the domain interleave) is detect-only, so
        detection happens HERE and recovery is a full repack; under TMR
        the pass resyncs the diverged copy (events already closed at
        injection by the majority vote)."""
        pcost = am.protection_cost
        self.n_scrubs += 1
        self.energy_j += pcost.scrub_energy_j
        now += pcost.scrub_s
        dirty = [e for e in self.events
                 if e.model == am.name and e.kind in ("single", "mbu")
                 and e.detected_at is None]
        if dirty:
            for e in dirty:
                e.detected_at = now
            now = self._repack(am, now, action="scrub+repack")
        return now

    def _run_priced_canary(self, am: _ArmedModel, now: float
                           ) -> Tuple[bool, float]:
        """Run one canary, advancing the clock by its modeled service
        and charging its modeled energy. Returns (passed, new now)."""
        passed, _ = am.canary.check()
        self.n_self_tests += 1
        self.energy_j += am.canary.cost.energy_j
        return passed, now + am.canary.cost.latency_s

    def _self_test(self, sched, am: _ArmedModel, now: float) -> float:
        passed, now = self._run_priced_canary(am, now)
        if passed:
            return now
        for ev in self.events:
            if ev.model == am.name and ev.detected_at is None:
                ev.detected_at = now
        if self.config.recovery == "demote":
            svc = sched._svcs[am.name]
            if len(svc.backends) < 2:
                raise RuntimeError(
                    f"recovery='demote' needs a fallback backend for "
                    f"{am.name!r}; it registered only {svc.backends}")
            svc.quarantined.add(am.backend)
            am.repair_at = now + self.config.repair_delay_s
            return now
        return self._repack(am, now, action="repack")

    def _repack(self, am: _ArmedModel, now: float, action: str) -> float:
        """Restore the whole arena from pristine host copies (scrubbing
        cannot localize the flip), price it, and re-verify bit-exact."""
        nbytes = am.plan.repack_weights()
        hw = energy_mod.BACKEND_HW[am.plan.backend]
        cost = energy_mod.repack_cost(hw, nbytes)
        now += cost.seconds
        self.energy_j += cost.energy_j
        self.n_recoveries += 1
        passed, now = self._run_priced_canary(am, now)
        if not passed:
            raise RuntimeError(
                f"arena re-pack for {am.name!r} did not restore the "
                f"pristine canary digest — host weight copies corrupt?")
        for ev in self.events:
            if ev.model == am.name and ev.recovered_at is None:
                if ev.detected_at is None:
                    # injected between detection and this repack (e.g.
                    # during a demote quarantine): the full-arena scrub
                    # restores it collaterally, and the verification
                    # canary that just passed is its detection record
                    ev.detected_at = now
                ev.recovered_at = now
                ev.action = action
        return now

    def _repair(self, sched, am: _ArmedModel, now: float) -> float:
        now = self._repack(am, now, action="demote+repack")
        sched._svcs[am.name].quarantined.discard(am.backend)
        am.repair_at = None
        return now

    # -- reporting -----------------------------------------------------------

    def drift_report(self, sched, window_s: Optional[float] = None,
                     now: Optional[float] = None
                     ) -> Dict[str, Dict[str, Optional[float]]]:
        """Observed-vs-modeled service-time ratio per armed (backend,
        rung) — the always-on complementary detection signal: a hard
        fault that slows a backend (retries, bus errors) shows up as
        ratio drift even between self-tests.

        Without a window: EWMA estimate / plan-time modeled latency
        (under ``clock="modeled"`` every ratio is exactly 1.0 —
        estimates ARE the signatures). With ``window_s``: the mean
        service time of dispatches RETIRED inside ``[now - window_s,
        now]`` over the modeled latency, per cell.

        A cell is ``None`` — never nan/inf — when it has no meaningful
        ratio: zero retired dispatches in the window (the 0/0 that used
        to leak out as nan), or a zero modeled latency."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name in self._models:
            svc = sched._svcs[name]
            ratios: Dict[str, Optional[float]] = {}
            if window_s is None:
                for (b, r), est in sorted(svc.est_service.items()):
                    lat = svc.costs[(b, r)].latency_s
                    ratios[f"{b}/b{r}"] = est / lat if lat > 0.0 else None
            else:
                if now is None:
                    done = [d.started + d.service_time
                            for d in sched.dispatches]
                    now = max(done, default=0.0)
                lo = now - window_s
                obs: Dict[Tuple[str, int], List[float]] = {}
                for d in sched.dispatches:
                    retired = d.started + d.service_time
                    if (d.model == name and not d.failed
                            and lo <= retired <= now):
                        obs.setdefault((d.backend, d.rung),
                                       []).append(d.service_time)
                for (b, r) in sorted(svc.costs):
                    lat = svc.costs[(b, r)].latency_s
                    cell = obs.get((b, r))
                    ratios[f"{b}/b{r}"] = (
                        None if not cell or lat <= 0.0
                        else (sum(cell) / len(cell)) / lat)
            out[name] = ratios
        return out

    def report(self) -> Dict[str, Any]:
        detected = [e for e in self.events if e.detected_at is not None]
        recovered = [e for e in self.events if e.recovered_at is not None]
        per_class: Dict[str, Dict[str, Any]] = {}
        for kind in ("single", "mbu", "control"):
            evs = [e for e in self.events if e.kind == kind]
            lats = [e.detection_latency_s for e in evs
                    if e.detected_at is not None]
            per_class[kind] = {
                "n_injected": len(evs),
                "n_detected": sum(1 for e in evs
                                  if e.detected_at is not None),
                "n_recovered": sum(1 for e in evs
                                   if e.recovered_at is not None),
                "max_detection_latency_s": max(lats, default=0.0),
            }
        return {
            "n_injected": len(self.events),
            "n_detected": len(detected),
            "n_recovered": len(recovered),
            "n_self_tests": self.n_self_tests,
            "n_recoveries": self.n_recoveries,
            "n_control_checks": self.n_control_checks,
            "n_scrubs": self.n_scrubs,
            "n_corrected": self.n_corrected,
            "overhead_energy_j": self.energy_j,
            "max_detection_latency_s": max(
                (e.detection_latency_s for e in detected), default=0.0),
            "per_class": per_class,
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The controller's restorable state as a JSON-serializable
        tree (save alongside the scheduler's ``state_dict()`` through
        :func:`save_checkpoint`): the pending upset schedule, the event
        ledger, all counters, the injector RNG state, the per-model
        timers, and the control-state shadows. Restoring into a freshly
        armed controller resumes a mid-storm timeline dispatch-for-
        dispatch identically (the §16 watchdog-reboot contract)."""
        return {
            "version": 1,
            "pending": [dataclasses.asdict(ev) for ev in self._pending],
            "events": [dataclasses.asdict(e) for e in self.events],
            "energy_j": float(self.energy_j),
            "n_self_tests": int(self.n_self_tests),
            "n_recoveries": int(self.n_recoveries),
            "n_control_checks": int(self.n_control_checks),
            "n_scrubs": int(self.n_scrubs),
            "n_corrected": int(self.n_corrected),
            "n_flips": int(self.injector.n_flips),
            "rng_state": self.injector._rng.bit_generator.state,
            "next_control_check": self._next_control_check,
            "models": {name: {"next_test": am.next_test,
                              "repair_at": am.repair_at,
                              "next_scrub": am.next_scrub}
                       for name, am in self._models.items()},
            "shadow": {name: {
                "est_service": [[b, r, t] for (b, r), t
                                in sorted(sh["est_service"].items())],
                "seeded": [[b, r] for (b, r) in sorted(sh["seeded"])]}
                for name, sh in self._shadow.items()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict` into THIS controller. Requires the
        same models already armed (a reboot re-arms against pristine
        weights first — re-packing the arena and re-pinning the canary —
        then the ledger restore resumes the storm timeline)."""
        if state.get("version") != 1:
            raise ValueError(f"unsupported controller checkpoint version "
                             f"{state.get('version')!r}")
        if set(state["models"]) != set(self._models):
            raise ValueError(
                f"checkpoint arms {sorted(state['models'])} but this "
                f"controller arms {sorted(self._models)}")
        self._pending = [UpsetEvent(t=float(ev["t"]), kind=str(ev["kind"]),
                                    span=int(ev["span"]),
                                    target=str(ev["target"]))
                         for ev in state["pending"]]
        self.events = [FaultEvent(**e) for e in state["events"]]
        self.energy_j = float(state["energy_j"])
        self.n_self_tests = int(state["n_self_tests"])
        self.n_recoveries = int(state["n_recoveries"])
        self.n_control_checks = int(state["n_control_checks"])
        self.n_scrubs = int(state["n_scrubs"])
        self.n_corrected = int(state["n_corrected"])
        self.injector.n_flips = int(state["n_flips"])
        self.injector._rng.bit_generator.state = state["rng_state"]
        self._next_control_check = state["next_control_check"]
        for name, ms in state["models"].items():
            am = self._models[name]
            am.next_test = ms["next_test"]
            am.repair_at = ms["repair_at"]
            am.next_scrub = ms["next_scrub"]
        self._shadow = {name: {
            "est_service": {(str(b), int(r)): float(t)
                            for b, r, t in sh["est_service"]},
            "seeded": {(str(b), int(r)) for b, r in sh["seeded"]}}
            for name, sh in state["shadow"].items()}


# ---------------------------------------------------------------------------
# Protection-mode selection (DESIGN.md §16)
# ---------------------------------------------------------------------------


def choose_protection(backend: str, sig, packed_bytes: int, canary_cost,
                      upset_rate: float, p_uncorrectable: float = 0.0,
                      self_test_period: float = 0.05,
                      scrub_period_s: float = 0.05,
                      throughput_inf_s: Optional[float] = None
                      ) -> Tuple[str, Dict[str, float]]:
    """The dispatcher's protection trade at a given arena upset rate:
    effective modeled J/inference of each mode, standing costs folded
    in. Returns ``(argmin mode, {mode: effective J/inf})``.

    * **'none'** (canary-only): the unprotected dispatch energy, plus a
      standing canary budget (one canary dispatch per self-test period),
      plus per-upset damage — a full arena repack AND the inferences
      served corrupt until detection (half a period's worth, wasted).
    * **'ecc'**: the decode-drag-priced dispatch energy plus standing
      scrub power; only the ``p_uncorrectable`` burst fraction still
      costs a repack (detected within a scrub period).
    * **'tmr'**: the vote-priced, power-tripled dispatch energy plus
      scrub power; every arena upset is masked — no exposure at all.

    In a quiet orbit the canary budget undercuts any always-on
    protection; inside an SAA pass the per-upset damage term swamps it
    and the ordering flips. ``upset_rate`` is the ARENA upset rate
    (upsets/virtual s; control-path upsets cost the same in every mode
    and cancel).
    ``throughput_inf_s`` defaults to the signature's saturated rate."""
    if self_test_period <= 0.0:
        raise ValueError("self_test_period must be > 0")
    if upset_rate < 0.0 or not 0.0 <= p_uncorrectable <= 1.0:
        raise ValueError("need upset_rate >= 0 and p_uncorrectable in "
                         "[0, 1]")
    hw = energy_mod.BACKEND_HW[backend]
    if throughput_inf_s is None:
        throughput_inf_s = sig.batch / sig.latency_s
    repack = energy_mod.repack_cost(hw, packed_bytes)
    table: Dict[str, float] = {}
    for mode in energy_mod.PROTECTION_MODES:
        pcost = energy_mod.protection_cost(hw, packed_bytes, mode,
                                           scrub_period_s)
        psig = energy_mod.protected_signature(sig, hw, pcost)
        standing_w = pcost.scrub_power_w
        if mode == "none":
            standing_w += canary_cost.energy_j / self_test_period
            exposure_j = (0.5 * self_test_period * throughput_inf_s
                          * sig.j_per_inference)
            standing_w += upset_rate * (repack.energy_j + exposure_j)
        elif mode == "ecc":
            exposure_j = (0.5 * scrub_period_s * throughput_inf_s
                          * sig.j_per_inference)
            standing_w += (upset_rate * p_uncorrectable
                           * (repack.energy_j + exposure_j))
        table[mode] = (psig.j_per_inference
                       + standing_w / throughput_inf_s)
    best = min(energy_mod.PROTECTION_MODES, key=lambda m: table[m])
    return best, table


# ---------------------------------------------------------------------------
# Checkpoint files (DESIGN.md §13)
# ---------------------------------------------------------------------------


def _lift_arrays(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Replace every ndarray in a state tree with an ``__array__:aN``
    placeholder, collecting the arrays — what makes the metadata pure
    JSON and the file loadable with ``allow_pickle=False``."""
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return _ARRAY_TAG + key
    if isinstance(obj, dict):
        return {str(k): _lift_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_lift_arrays(v, arrays) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def _sink_arrays(obj: Any, data) -> Any:
    if isinstance(obj, str) and obj.startswith(_ARRAY_TAG):
        return data[obj[len(_ARRAY_TAG):]]
    if isinstance(obj, dict):
        return {k: _sink_arrays(v, data) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sink_arrays(v, data) for v in obj]
    return obj


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write a scheduler ``state_dict()`` (or any JSON+ndarray tree) to
    one ``.npz``: ``__meta__`` holds the JSON skeleton, ``aN`` entries
    hold the lifted arrays. No pickling on either side; a torch tensor
    in the tree is not JSON and is refused (state goes out as numpy)."""
    arrays: Dict[str, np.ndarray] = {}
    meta = _lift_arrays(state, arrays)
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrays)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        return _sink_arrays(meta, data)
