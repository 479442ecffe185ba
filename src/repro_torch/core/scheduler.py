"""Continuous-batching serving scheduler over the staged plan cache.

The paper's motivating workload is a request *stream*: sensor frames
arrive continuously (FPI ion distributions every survey cycle, SHARP
magnetogram tiles, GOES channel samples) and are filtered on-board to
ease downlink pressure. The fixed-batch ``ServingPipeline`` consumes a
pre-materialized list at one batch size; this module adds the layer a
real deployment needs on top of it:

* **per-model request queues** with arrival timestamps and per-use-case
  latency *deadlines* (each mission cadence implies one — see
  ``DEFAULT_DEADLINES``),
* a precompiled **batch-size ladder** per (model, backend): one compiled
  program per rung, built at ``register()`` time, so serving never
  lowers a plan again,
* a dispatch policy that **waits to fill**: a queue dispatches at the
  largest ladder rung once it holds a full top-rung batch, but the
  whole ragged tail is **flushed early into one padded batch** when the
  oldest request's deadline gets within a safety margin of the measured
  service time — batch-fill is traded for latency exactly when the
  deadline forces it,
* **round-robin fairness** across concurrently registered models (the
  on-board reality: one accelerator, several instruments),
* an optional orbital **power envelope** (``core/energy.py``): a model
  may register SEVERAL backends (primary first); each (backend, rung)
  carries its plan-time cost signature, and every dispatch must be
  admitted by the envelope — the dispatcher picks the cheapest-energy
  admissible backend, falls back (DPU -> CPU/HLS) when the budget
  tightens, and *defers* (recording the deferral) when nothing fits,
  advancing the virtual clock to the envelope's next-admit time. With no
  envelope the dispatch sequence is exactly the plain deadline policy on
  the primary backend, and
* per-model **telemetry**: p50/p99 latency, fps, batch-fill histogram
  per rung, deadline misses, the selective-downlink reduction ratio,
  and — per the envelope — modeled energy, J/inference, duty cycle,
  backend mix, and deferral counts.

Execution of one dispatched batch is delegated to
``ServingPipeline.execute_batch`` (core/pipeline.py) — the scheduler owns
*when and how many*, the pipeline owns *staging, padding, compute, and
the keep predicate*.

``pipeline=True`` switches dispatch to the ASYNC ticket
path: ``execute_batch_async`` returns without forcing the outputs, up to
``staging_buffers`` dispatches stay in flight (each owning a reusable
host staging slot), and tickets retire lazily — at slot-pool pressure,
at every telemetry boundary, and at stream end. EWMA service times are
observed at ticket retirement. Dispatch DECISIONS are unchanged, and
under ``clock="modeled"`` pipelined serving is dispatch-for-dispatch and
bit-exact identical to ``pipeline=False``; the overlap a pipelined
deployment would realize is priced by a deterministic per-resource
occupancy ledger (``overlap_report()``).

Two driving modes share the same ``step()`` core:

* ``serve_trace(trace)`` — deterministic virtual-clock simulation:
  arrivals happen at trace timestamps, service occupies the (measured)
  execution time of each dispatched plan call. This is what the
  benchmarks and property tests drive.
* ``start()/submit()/stop()`` — a background dispatcher thread against
  the wall clock, for asynchronous producers.

``LMScheduler`` (at the end) is the LM's own loop: prefill admission on a
rung ladder, then batched decode steps over the in-flight requests' KV
slots, streaming tokens as they retire.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.energy import (CostSignature, Draw, PipelineTimeline,
                               PowerEnvelope, StageCost)
from repro_torch.core.pipeline import (BatchResult, DispatchTicket,
                                       ServingPipeline, split_seeds)

DEFAULT_LADDER = (1, 4, 16, 32)
BACKENDS = ("cpu", "flex", "accel")


def capped_ladder(top: int, base: Sequence[int] = DEFAULT_LADDER
                  ) -> Tuple[int, ...]:
    """``base`` clamped to a caller-chosen top rung (which joins the
    ladder if it isn't a base rung) — the one place launchers derive a
    ladder from a ``--batch`` flag."""
    if top < 1:
        raise ValueError(f"top rung must be >= 1, got {top}")
    return tuple(sorted({r for r in base if r < top} | {top}))

# Per-use-case latency deadlines (seconds), mirroring mission cadences:
# the MMS nets must keep up with FPI burst-mode distributions (150 ms
# cadence); ESPERTA scores proton-event features as they are derived;
# CNet ingests SDO full-disk images at ~1-min cadence; the VAE compresses
# SHARP magnetogram tiles (45 s product cadence). A result that misses
# the next sensor frame is stale, so the deadline is one cadence.
DEFAULT_DEADLINES = {
    "baseline_net": 0.150,
    "reduced_net": 0.150,
    "logistic_net": 0.150,
    "multi_esperta": 1.0,
    "cnet_plus_scalar": 2.0,
    "vae_encoder": 1.0,
}
FALLBACK_DEADLINE = 0.5


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    model: str
    inputs: Dict[str, np.ndarray]
    arrival: float
    deadline: float                     # absolute completion deadline


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    model: str
    outputs: Dict[str, np.ndarray]
    kept: bool
    arrival: float
    finished: float
    rung: int                           # compiled batch size dispatched at
    n_real: int                         # real (non-padding) requests in it
    deadline: float

    @property
    def latency(self) -> float:
        return self.finished - self.arrival

    @property
    def missed_deadline(self) -> bool:
        return self.finished > self.deadline


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    model: str
    rung: int
    n_real: int
    started: float
    service_time: float
    mode: str                           # 'full' | 'flush'
    backend: str = ""                   # backend the batch ran on
    energy_j: float = 0.0               # modeled energy of the dispatch
    power_w: float = 0.0                # modeled busy power while it ran
    failed: bool = False                # retirement raised; batch requeued

    @property
    def fill(self) -> float:
        return self.n_real / self.rung

    @property
    def modeled_latency_s(self) -> float:
        return self.energy_j / self.power_w if self.power_w > 0 else 0.0


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unretired batch in pipelined mode: everything the
    scheduler needs to finish the bookkeeping (EWMA observation, the
    measured service rewrite, completions) when the ticket retires."""
    ticket: DispatchTicket
    reqs: List[Request]
    svc: "_ModelService"
    backend: str
    rung: int
    n_real: int
    started: float                      # virtual dispatch time
    sig: CostSignature
    draw: Optional[Draw]
    rec_idx: int                        # index into scheduler.dispatches
    t0: float                           # wall perf_counter at dispatch


@dataclasses.dataclass(frozen=True)
class DeferralRecord:
    """A dispatch opportunity the envelope refused: the model was due
    (full batch or deadline flush) but no backend's draw was admissible."""
    model: str
    time: float
    rung: int
    n_real: int


@dataclasses.dataclass
class ModelTelemetry:
    model: str
    deadline_s: float
    n_submitted: int = 0
    n_completed: int = 0
    n_kept: int = 0
    deadline_misses: int = 0
    fps: float = 0.0
    p50_latency_ms: float = 0.0
    p99_latency_ms: float = 0.0
    mean_batch_fill: float = 0.0
    fill_hist: Dict[int, Dict[str, float]] = dataclasses.field(
        default_factory=dict)           # rung -> {dispatches, mean_fill}
    n_dispatches: int = 0
    # -- energy accounting (modeled; populated from cost signatures) --------
    energy_j: float = 0.0               # total modeled J across dispatches
    j_per_inference: float = 0.0
    duty_cycle: float = 0.0             # modeled busy time / serving span
    n_deferrals: int = 0                # envelope-refused dispatch chances
    backend_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # -- degraded-mode accounting ---------------------------------------------
    n_staging_fallbacks: int = 0        # host arena pool misses (fresh alloc)
    n_failed_dispatches: int = 0        # dispatches whose retirement raised

    @property
    def downlink_reduction(self) -> float:
        return 1.0 - self.n_kept / max(self.n_completed, 1)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fill_hist"] = {str(k): v for k, v in self.fill_hist.items()}
        d["downlink_reduction"] = self.downlink_reduction
        return d


# ---------------------------------------------------------------------------
# Arrival traces (virtual-clock simulation inputs)
# ---------------------------------------------------------------------------


def poisson_arrivals(rate_hz: float, n: int, seed: int = 0,
                     start: float = 0.0) -> List[float]:
    """``n`` Poisson-process arrival times at ``rate_hz`` (exp gaps)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return [float(t) for t in start + np.cumsum(gaps)]


def bursty_arrivals(n: int, burst_size: int, gap_s: float,
                    intra_s: float = 0.0, seed: int = 0,
                    start: float = 0.0) -> List[float]:
    """Bursts of ``burst_size`` back-to-back arrivals every ``gap_s``
    (the paper's regime: an instrument dumps a survey window at once).
    ``intra_s`` jitters samples inside a burst."""
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = start
    while len(times) < n:
        for i in range(min(burst_size, n - len(times))):
            times.append(float(t + (rng.uniform(0, intra_s)
                                    if intra_s else 0.0)))
        t += gap_s
    return sorted(times)


# ---------------------------------------------------------------------------
# Per-model service state
# ---------------------------------------------------------------------------


class _ModelService:
    def __init__(self, name: str,
                 pipelines: Dict[str, Dict[int, ServingPipeline]],
                 deadline_s: float, flush_safety: float):
        self.name = name
        # backend -> rung -> pipeline; insertion order = preference order
        # (primary first — what an unconstrained dispatch uses)
        self.pipelines = pipelines
        self.backends: Tuple[str, ...] = tuple(pipelines)
        self.ladder: Tuple[int, ...] = tuple(
            sorted(pipelines[self.backends[0]]))
        self.costs: Dict[Tuple[str, int], CostSignature] = {
            (b, r): p.cost
            for b, rungs in pipelines.items() for r, p in rungs.items()}
        # the plans' stage decompositions — what the pipelined overlap
        # ledger prices each dispatch with
        self.stages: Dict[Tuple[str, int], Tuple[StageCost, ...]] = {
            (b, r): p.stages
            for b, rungs in pipelines.items() for r, p in rungs.items()}
        self.deadline_s = deadline_s
        self.flush_safety = flush_safety
        self.queue: Deque[Request] = deque()
        self.n_submitted = 0
        self.n_deferred = 0
        self._last_deferred_rid: Optional[int] = None
        # EWMA service-time estimate per (backend, rung). Seeded at
        # register time from the plan's modeled CostSignature latency so
        # the very FIRST ragged-tail flush decision is cadence-correct
        # (the old cold-start margin of 0 made the first dispatch flush
        # exactly at the deadline, too late to compute). A seed is a
        # PRIOR: the first real observation replaces it outright (host
        # wall time and modeled ZCU104 time differ in scale); later
        # observations EWMA as before.
        self.est_service: Dict[Tuple[str, int], float] = {}
        self._seeded: set = set()
        # backends quarantined by the fault controller (demotion
        # recovery): dispatch skips them until repaired. Empty set ->
        # dispatch is identical to the unfaulted scheduler.
        self.quarantined: set = set()
        # arena protection mode applied by the fault controller: 'none'
        # until `apply_protection` swaps the cost signatures for
        # ECC/TMR-priced ones.
        self.protection: str = "none"
        # per-service seed chain: each dispatch takes the next [2] uint32
        # seed, from which its pipeline derives one seed pair per sample
        self._rng = np.array(
            [np.frombuffer(name.encode()[:4].ljust(4, b"\0"), np.uint32)[0],
             0], np.uint32)

    def next_rng(self) -> np.ndarray:
        self._rng, sub = split_seeds(self._rng, 2)
        return sub

    @property
    def active_backends(self) -> Tuple[str, ...]:
        """Registration-ordered backends minus the quarantined set. If
        EVERY backend is quarantined, serving beats stopping: fall back
        to the full registration list rather than starve the queue."""
        act = tuple(b for b in self.backends if b not in self.quarantined)
        return act or self.backends

    def seed_service(self, backend: str, rung: int, seconds: float) -> None:
        """Install a modeled prior for the flush margin; replaced (not
        averaged) by the first real observation."""
        self.est_service[(backend, rung)] = seconds
        self._seeded.add((backend, rung))

    def observe_service(self, backend: str, rung: int,
                        seconds: float) -> None:
        key = (backend, rung)
        old = self.est_service.get(key)
        if old is None or key in self._seeded:
            self._seeded.discard(key)
            self.est_service[key] = seconds
        else:
            self.est_service[key] = 0.5 * old + 0.5 * seconds

    def flush_margin(self) -> float:
        """How long before the oldest deadline we must start computing:
        safety x the worst estimated rung service time on the PRIMARY
        backend (fallback backends may be orders slower — budgeting for
        them would flush everything immediately). Every rung is seeded
        with its modeled CostSignature latency at register time, so the
        margin is cadence-correct from the very first flush decision;
        real observations replace the seeds as dispatches happen."""
        primary = self.active_backends[0]
        worst = max((t for (b, _), t in self.est_service.items()
                     if b == primary), default=0.0)
        return self.flush_safety * worst

    def flush_time(self) -> Optional[float]:
        if not self.queue:
            return None
        return self.queue[0].deadline - self.flush_margin()

    def pick(self, now: float) -> Optional[Tuple[str, int, int]]:
        """(mode, rung, n_real) to dispatch at ``now``, or None to wait.

        * ``full``  — a full top-rung batch is waiting: dispatch it at
          100% fill (the largest ladder rung <= queue depth).
        * ``flush`` — the oldest request's deadline is within the safety
          margin: flush the WHOLE ragged tail as one batch, padded up to
          the smallest rung that holds it (its queue-mates' deadlines
          trail the oldest by arrival gaps, so one padded dispatch
          minimizes their worst-case latency too).
        """
        depth = len(self.queue)
        if depth == 0:
            return None
        top = self.ladder[-1]
        if depth >= top:
            return ("full", top, top)
        ft = self.flush_time()
        if ft is not None and ft <= now:
            n_real = min(depth, top)
            rung = self.ladder[bisect.bisect_left(self.ladder, n_real)]
            return ("flush", rung, n_real)
        return None


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


class ContinuousBatchingScheduler:
    """Co-serves several space models from one process: per-model queues,
    a precompiled batch ladder each, deadline-bounded batch filling, and
    round-robin dispatch across models.

    ``envelope`` (a :class:`~repro.core.energy.PowerEnvelope`) makes
    dispatch energy-budget-aware: every dispatch charges the envelope
    with the plan-time modeled (W, latency) of its cost signature, and a
    model registered with several backends falls back to the cheapest
    admissible one. With ``envelope=None`` the dispatch sequence is
    byte-for-byte the plain deadline policy on the primary backend.

    ``clock`` selects what one dispatch *occupies* on the virtual clock:
    ``"measured"`` (default) uses this host's wall time per batch —
    honest for host benchmarking; ``"modeled"`` uses the cost signature's
    analytic latency, making ``serve_trace`` a deterministic,
    machine-independent simulation of the modeled deployment timeline
    (what the energy benchmarks and CI gates drive).
    """

    def __init__(self, flush_safety: float = 2.0,
                 envelope: Optional[PowerEnvelope] = None,
                 clock: str = "measured",
                 pipeline: bool = False,
                 staging_buffers: int = 2):
        if clock not in ("measured", "modeled"):
            raise ValueError(f"clock must be measured|modeled, got {clock}")
        if staging_buffers < 1:
            raise ValueError(
                f"staging_buffers must be >= 1, got {staging_buffers}")
        self.flush_safety = flush_safety
        self.envelope = envelope
        self.clock = clock
        self.pipeline = bool(pipeline)
        self.staging_buffers = int(staging_buffers)
        # dispatched-but-unretired tickets, FIFO in dispatch order; depth
        # is capped at staging_buffers (retiring the oldest frees its
        # host slot before a new dispatch would need one)
        self._inflight: Deque[_Inflight] = deque()
        self.timeline: Optional[PipelineTimeline] = (
            PipelineTimeline() if pipeline else None)
        self._svcs: Dict[str, _ModelService] = {}
        self._order: List[str] = []     # round-robin rotation
        self._rr = 0
        self._next_rid = 0
        self._lock = threading.RLock()
        self.completions: List[Completion] = []
        self.dispatches: List[DispatchRecord] = []
        self.deferrals: List[DeferralRecord] = []
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None
        self._stop = threading.Event()
        # optional degraded-mode controller (core/faults.py); None keeps
        # serve_trace dispatch-for-dispatch the unfaulted loop
        self._faults = None

    # -- setup --------------------------------------------------------------

    def register(self, name: str, engine, backend="flex",
                 ladder: Sequence[int] = DEFAULT_LADDER,
                 deadline_s: Optional[float] = None,
                 keep_predicate: Optional[Callable] = None,
                 warmup_sample: Optional[Dict[str, np.ndarray]] = None
                 ) -> None:
        """Precompile the batch ladder for every backend and open a queue.

        ``backend`` is one backend name or a preference-ordered sequence
        (primary first); under an envelope the dispatcher may fall back
        to any of them. ``warmup_sample`` (one request dict) additionally
        runs every (backend, rung) twice, paying first-call costs (kernel
        builds, allocator warm-up) up front and seeding the service-time estimates the deadline-flush
        margin uses."""
        backends = ((backend,) if isinstance(backend, str)
                    else tuple(backend))
        if not backends or any(b not in BACKENDS for b in backends):
            raise ValueError(f"bad backend(s) {backends}; "
                             f"choose from {BACKENDS}")
        if len(set(backends)) != len(backends):
            raise ValueError(f"duplicate backends {backends}")
        ladder = tuple(sorted(set(int(r) for r in ladder)))
        if not ladder or ladder[0] < 1:
            raise ValueError(f"bad ladder {ladder}")
        pipelines = {
            b: {r: ServingPipeline(engine, backend=b, batch_size=r,
                                   keep_predicate=keep_predicate,
                                   staging_buffers=self.staging_buffers)
                for r in ladder}
            for b in backends}
        if deadline_s is None:
            deadline_s = DEFAULT_DEADLINES.get(name, FALLBACK_DEADLINE)
        svc = _ModelService(name, pipelines, deadline_s, self.flush_safety)
        if self.envelope is not None:
            # the envelope must be able to admit at least ONE backend's
            # smallest-rung dispatch in some budget regime, or this model
            # could never be served
            bottom = ladder[0]
            if not any(self.envelope.feasible_ever(
                    svc.costs[(b, bottom)].power_w,
                    svc.costs[(b, bottom)].latency_s) for b in backends):
                raise ValueError(
                    f"power envelope can never admit any backend of "
                    f"{name!r} (smallest rung {bottom}); widen the budget "
                    f"or register a lower-power backend")
        # seed every (backend, rung) estimate from its plan-time cost
        # signature so the first flush decision is cadence-correct even
        # before any observation exists (a warmup or the first dispatch
        # REPLACES the seed — it is a prior, not a measurement)
        for key, sig in svc.costs.items():
            svc.seed_service(key[0], key[1], sig.latency_s)
        if warmup_sample is not None:
            for b in backends:
                for rung in ladder:
                    # first call pays first-run costs; the second is
                    # the steady-state service time the flush margin
                    # budgets for
                    pipelines[b][rung].execute_batch([warmup_sample] * rung)
                    t0 = time.perf_counter()
                    pipelines[b][rung].execute_batch([warmup_sample] * rung)
                    svc.observe_service(b, rung, time.perf_counter() - t0)
        if self.clock == "modeled":
            # the modeled clock serves on the cost signature's timeline —
            # estimates come from the plan, not this host (re-seeded so a
            # wall-clock warmup above cannot leak host time into the
            # deterministic simulation)
            for key, sig in svc.costs.items():
                svc.seed_service(key[0], key[1], sig.latency_s)
        with self._lock:
            if name in self._svcs:
                raise ValueError(f"model {name!r} already registered")
            self._svcs[name] = svc
            self._order.append(name)

    @property
    def models(self) -> List[str]:
        return list(self._order)

    def attach_faults(self, controller) -> None:
        """Attach a :class:`~repro_torch.core.faults.FaultController`:
        ``serve_trace`` ticks it every scheduling round (injection + due
        self-tests) and lets its pending event times drive the idle
        virtual-clock jumps."""
        self._faults = controller

    def apply_protection(self, model: str, mode: str,
                         costs: Dict[Tuple[str, int], CostSignature]
                         ) -> None:
        """Swap a model's cost signatures for protection-priced ones: the
        fault controller re-prices the protected (backend, rung) cells
        through `energy.protected_signature` and installs them here, so
        backend ranking, envelope admission and the modeled clock all see
        the ECC decode drag / TMR power tripling. Unlisted cells keep
        their unprotected signatures. Under the modeled clock the affected
        service estimates are re-seeded: the simulation serves on the
        protected timeline."""
        with self._lock:
            svc = self._svcs[model]
            for key, sig in costs.items():
                if key not in svc.costs:
                    raise KeyError(f"{model!r} has no (backend, rung) "
                                   f"cell {key}")
                svc.costs[key] = sig
                if self.clock == "modeled":
                    svc.seed_service(key[0], key[1], sig.latency_s)
            svc.protection = mode

    # -- submission ---------------------------------------------------------

    def submit(self, model: str, inputs: Dict[str, np.ndarray],
               arrival: Optional[float] = None) -> int:
        """Enqueue one request; returns its id. ``arrival`` defaults to the
        wall clock (async mode); trace mode passes virtual timestamps."""
        with self._lock:
            svc = self._svcs[model]
            arrival = time.monotonic() if arrival is None else float(arrival)
            rid = self._next_rid
            self._next_rid += 1
            svc.queue.append(Request(rid, model, inputs, arrival,
                                     arrival + svc.deadline_s))
            svc.n_submitted += 1
            return rid

    # -- dispatch core ------------------------------------------------------

    @staticmethod
    def _forced_pick(svc: _ModelService) -> Optional[Tuple[str, int, int]]:
        if not svc.queue:
            return None
        depth = min(len(svc.queue), svc.ladder[-1])
        rung = svc.ladder[bisect.bisect_left(svc.ladder, depth)]
        return ("flush", rung, depth)

    def _select_backend(self, svc: _ModelService, rung: int, now: float
                        ) -> Tuple[Optional[str], Optional[Draw]]:
        """The energy-aware backend decision for one picked dispatch:
        no envelope -> the primary backend, unconditionally. Under an
        envelope -> the admissible backend with the
        lowest modeled dispatch energy (ties resolve to registration
        order), charging the envelope; (None, None) means defer.
        Quarantined backends (fault demotion) are skipped entirely."""
        if self.envelope is None:
            return svc.active_backends[0], None
        ranked = sorted(svc.active_backends,
                        key=lambda b: svc.costs[(b, rung)].energy_j)
        for b in ranked:
            sig = svc.costs[(b, rung)]
            draw = self.envelope.admit(now, sig.power_w, sig.latency_s,
                                       tag=f"{svc.name}/{b}/b{rung}")
            if draw is not None:
                return b, draw
        return None, None

    def step(self, now: float, force: bool = False
             ) -> Optional[DispatchRecord]:
        """Dispatch at most ONE batch: scan models round-robin from the
        rotation pointer, serve the first one with a ready queue AND an
        envelope-admissible backend, advance the pointer past it. A due
        model whose every backend the envelope refuses is *deferred*
        (recorded; retried on the next step). ``force`` flushes
        regardless of deadlines (used by drain) but still respects the
        envelope. Returns the dispatch record, or None if every queue is
        waiting or deferred."""
        with self._lock:
            n = len(self._order)
            for k in range(n):
                name = self._order[(self._rr + k) % n]
                svc = self._svcs[name]
                picked = svc.pick(now)
                if picked is None and force:
                    picked = self._forced_pick(svc)
                if picked is None:
                    continue
                mode, rung, n_real = picked
                # envelope refusals degrade the rung: a smaller batch is a
                # shorter draw, so tight budgets serve smaller duty-cycled
                # chunks instead of deadlocking behind one big dispatch
                backend = draw = None
                for r in [x for x in reversed(svc.ladder) if x <= rung]:
                    backend, draw = self._select_backend(svc, r, now)
                    if backend is not None:
                        rung, n_real = r, min(n_real, r)
                        break
                if backend is None:
                    # one deferral per blocked batch-head, not per poll:
                    # the async dispatcher re-tries every poll_s and must
                    # not grow the record list unboundedly
                    head = svc.queue[0].rid
                    if head != svc._last_deferred_rid:
                        svc._last_deferred_rid = head
                        svc.n_deferred += 1
                        self.deferrals.append(
                            DeferralRecord(name, now, rung, n_real))
                    continue
                svc._last_deferred_rid = None
                reqs = [svc.queue.popleft() for _ in range(n_real)]
                self._rr = (self._rr + k + 1) % n
                break
            else:
                return None
            rng = svc.next_rng()
            sig = svc.costs[(backend, rung)]

        if self.pipeline:
            return self._step_pipelined(svc, reqs, backend, rung, n_real,
                                        mode, now, sig, draw, rng)

        t0 = time.perf_counter()
        try:
            result: BatchResult = svc.pipelines[backend][rung].execute_batch(
                [r.inputs for r in reqs], rng=rng)
        except BaseException:
            # no silent loss: put the popped batch back at the queue head
            # (original order) and refund the envelope draw before
            # surfacing the error
            with self._lock:
                svc.queue.extendleft(reversed(reqs))
                if draw is not None:
                    self.envelope.remove(draw)
            raise
        measured = time.perf_counter() - t0
        service = sig.latency_s if self.clock == "modeled" else measured

        with self._lock:
            svc.observe_service(backend, rung, service)
            finished = now + service
            rec = DispatchRecord(svc.name, rung, n_real, now, service, mode,
                                 backend=backend, energy_j=sig.energy_j,
                                 power_w=sig.power_w)
            self.dispatches.append(rec)
            for i, req in enumerate(reqs):
                self.completions.append(Completion(
                    req.rid, req.model,
                    {k: v[i] for k, v in result.outputs.items()},
                    result.keep[i], req.arrival, finished, rung, n_real,
                    req.deadline))
            return rec

    # -- pipelined dispatch -------------------------------------------------

    def _step_pipelined(self, svc: _ModelService, reqs: List[Request],
                        backend: str, rung: int, n_real: int, mode: str,
                        now: float, sig: CostSignature,
                        draw: Optional[Draw], rng: np.ndarray
                        ) -> DispatchRecord:
        """The non-blocking tail of one picked dispatch: issue an async
        ticket, append the dispatch record immediately, and defer EWMA +
        completions to retirement. The dispatch DECISION (queue pops,
        envelope draw, rung) already happened in `step` — identical to
        the synchronous path by construction, and under the modeled
        clock every recorded number (service_time, finished) is the same
        cost-signature latency the synchronous path records, so
        pipelined serving is dispatch-for-dispatch and bit-exact
        identical to ``pipeline=False``."""
        # retiring the oldest ticket(s) first keeps at most
        # staging_buffers dispatches in flight — so every pipeline's
        # slot pool can double-buffer instead of falling back to fresh
        # allocations
        self._drain_inflight(self.staging_buffers - 1)
        t0 = time.perf_counter()
        try:
            ticket = svc.pipelines[backend][rung].execute_batch_async(
                [r.inputs for r in reqs], rng=rng)
        except BaseException:
            # staging runs synchronously inside the async dispatch, so a
            # poison request surfaces HERE — same recovery as the
            # synchronous path: batch back at the queue head, draw
            # refunded
            with self._lock:
                svc.queue.extendleft(reversed(reqs))
                if draw is not None:
                    self.envelope.remove(draw)
            raise
        dispatch_s = time.perf_counter() - t0
        # modeled clock: the dispatch occupies its modeled latency (the
        # identical virtual-clock advance the synchronous path makes).
        # measured clock: the server is only busy for the non-blocking
        # dispatch call — overlap is the point — and the record's
        # service_time is rewritten to the true dispatch->retirement
        # time when the ticket retires.
        service = sig.latency_s if self.clock == "modeled" else dispatch_s
        with self._lock:
            rec = DispatchRecord(svc.name, rung, n_real, now, service, mode,
                                 backend=backend, energy_j=sig.energy_j,
                                 power_w=sig.power_w)
            rec_idx = len(self.dispatches)
            self.dispatches.append(rec)
            self._inflight.append(_Inflight(
                ticket, reqs, svc, backend, rung, n_real, now, sig, draw,
                rec_idx, t0))
            if self.timeline is not None:
                # overlap accounting: the pipelined deployment could
                # start this batch's staging as soon as its data had
                # arrived and the host channel was free
                self.timeline.add(svc.stages[(backend, rung)],
                                  earliest=max(r.arrival for r in reqs))
        return rec

    def _retire(self, inf: _Inflight) -> None:
        """Finish one in-flight dispatch: force its outputs (releasing
        the staging slot), observe the EWMA service time from ticket
        retirement, and emit its completions (FIFO retirement keeps
        completion order identical to the synchronous path)."""
        try:
            result = inf.ticket.retire()
        except BaseException:
            # no silent loss on an async failure either: batch back at
            # the queue head in original order, with the ORIGINAL arrival
            # timestamps and deadlines (Request objects are frozen), and
            # the draw refunded. The dispatch record is marked failed so
            # the inevitable re-dispatch cannot double-count the batch in
            # p50/p99, fill-histogram, or energy telemetry.
            with self._lock:
                inf.svc.queue.extendleft(reversed(inf.reqs))
                if inf.draw is not None:
                    self.envelope.remove(inf.draw)
                self.dispatches[inf.rec_idx] = dataclasses.replace(
                    self.dispatches[inf.rec_idx], failed=True)
            raise
        measured = time.perf_counter() - inf.t0
        service = inf.sig.latency_s if self.clock == "modeled" else measured
        with self._lock:
            inf.svc.observe_service(inf.backend, inf.rung, service)
            if self.clock != "modeled":
                # telemetry should report the true dispatch->retirement
                # service; the virtual clock already advanced by the
                # non-blocking dispatch time at dispatch
                self.dispatches[inf.rec_idx] = dataclasses.replace(
                    self.dispatches[inf.rec_idx], service_time=service)
            finished = inf.started + service
            for i, req in enumerate(inf.reqs):
                self.completions.append(Completion(
                    req.rid, req.model,
                    {k: v[i] for k, v in result.outputs.items()},
                    result.keep[i], req.arrival, finished, inf.rung,
                    inf.n_real, req.deadline))

    def _drain_inflight(self, keep: int = 0) -> None:
        """Retire oldest-first until at most ``keep`` remain in flight."""
        while True:
            with self._lock:
                if len(self._inflight) <= keep:
                    return
                inf = self._inflight.popleft()
            self._retire(inf)

    def sync(self) -> None:
        """Retire every in-flight ticket — the telemetry/stream barrier.
        A no-op in synchronous mode (nothing is ever in flight)."""
        self._drain_inflight(0)

    def _earliest_admit(self, svc: _ModelService, rung: int, now: float
                        ) -> Optional[float]:
        """Earliest time the envelope could admit SOME (backend, rung <=
        picked rung) of a due dispatch — how far a blocked virtual clock
        advances (step degrades rungs the same way)."""
        times = []
        for b in svc.active_backends:
            for r in svc.ladder:
                if r > rung:
                    break
                sig = svc.costs[(b, r)]
                t = self.envelope.next_admit(now, sig.power_w, sig.latency_s)
                if t is not None:
                    times.append(t)
        return min(times) if times else None

    def next_event_time(self, now: Optional[float] = None
                        ) -> Optional[float]:
        """Earliest instant the dispatch decision can change: the next
        deadline flush — or, for a queue that is due *now* but
        envelope-blocked, the envelope's next-admit time."""
        with self._lock:
            times = []
            for svc in self._svcs.values():
                picked = svc.pick(now) if now is not None else None
                if picked is not None and self.envelope is not None:
                    t = self._earliest_admit(svc, picked[1], now)
                    if t is not None:
                        times.append(max(t, now + 1e-9))
                    continue
                ft = svc.flush_time()
                if ft is not None:
                    times.append(ft)
            return min(times) if times else None

    def pending(self) -> int:
        with self._lock:
            return sum(len(svc.queue) for svc in self._svcs.values())

    def drain(self, now: float) -> float:
        """Flush every queue to empty (end of stream); returns the final
        virtual time. Under an envelope a blocked drain advances the
        clock to the next admissible instant instead of spinning."""
        while self.pending():
            rec = self.step(now, force=True)
            if rec is not None:
                now += rec.service_time
                continue
            if self.envelope is None:       # unreachable without envelope
                raise RuntimeError("drain stalled with requests pending")
            admits = []
            with self._lock:
                for svc in self._svcs.values():
                    picked = self._forced_pick(svc)
                    if picked is None:
                        continue
                    t = self._earliest_admit(svc, picked[1], now)
                    if t is not None:
                        admits.append(t)
            if not admits:
                raise RuntimeError(
                    "power envelope can never admit the remaining queued "
                    "dispatches; widen the budget")
            now = max(min(admits), now + 1e-9)
        self.sync()                     # end of stream: retire everything
        return now

    # -- virtual-clock trace serving ----------------------------------------

    def serve_trace(self, trace: Sequence[Tuple[float, str, Dict]],
                    start: float = 0.0,
                    stop_at: Optional[float] = None) -> float:
        """Serve a pre-built arrival trace of ``(t, model, inputs)`` under a
        virtual clock: arrivals occur at trace time, each dispatch occupies
        its measured execution time. Deterministic given the trace; returns
        the final virtual time.

        ``stop_at`` halts the loop once the clock reaches that instant —
        the watchdog-reboot cut point: every arrival with ``t <=`` the
        returned time has been submitted (accepted into a queue, hence
        checkpointable), in-flight tickets are retired, and
        queued-but-undispatched requests stay queued. The caller resumes
        by replaying the remaining trace events (``t >`` the returned
        time) into a restored scheduler."""
        ev = sorted(trace, key=lambda e: e[0])
        now, i, n = start, 0, len(ev)
        while i < n or self.pending():
            while i < n and ev[i][0] <= now + 1e-12:
                self.submit(ev[i][1], ev[i][2], arrival=ev[i][0])
                i += 1
            if stop_at is not None and now >= stop_at - 1e-12:
                break                           # accepted, not yet served
            if self._faults is not None:
                now = self._faults.tick(self, now)
            rec = self.step(now)
            if rec is not None:
                now += rec.service_time         # server busy while computing
                continue
            nxt = ev[i][0] if i < n else None
            ft = self.next_event_time(now)
            if ft is not None:
                nxt = ft if nxt is None else min(nxt, ft)
            if self._faults is not None:
                et = self._faults.next_event_time(now)
                if et is not None:
                    nxt = et if nxt is None else min(nxt, et)
            if nxt is None:
                if self.pending():
                    # only reachable under an envelope whose remaining
                    # schedule can never admit the queued dispatches —
                    # surface it, never strand requests silently
                    raise RuntimeError(
                        "power envelope can never admit the remaining "
                        "queued dispatches; widen the budget")
                break
            # guarantee progress: a blocked queue's next event must move
            # the clock strictly forward
            now = max(now + 1e-9, nxt) if nxt <= now else nxt
        self.sync()                     # end of stream: retire everything
        if self._faults is not None and stop_at is None:
            now = self._faults.finalize(self, now)
        return now

    # -- checkpoint/restore -------------------------------------------------

    def state_dict(self) -> Dict:
        """The scheduler ledger as a plain-python/numpy tree: accepted
        queues (request ids, inputs, ORIGINAL arrivals and deadlines),
        EWMA service state, the per-model seed chain, quarantine sets,
        dispatch and deferral records, and completion METADATA (outputs
        are not checkpointed — completed results were already delivered,
        and the restored records keep p50/p99/fill telemetry exact).

        In-flight tickets are retired first (``sync()``): a checkpoint
        cut is a quiesce point, never a torn dispatch. Plans, packed
        weights and the pipeline timeline are NOT state — a reboot
        re-registers the same models, then :meth:`load_state_dict`
        overlays this ledger. Nothing in the tree is a torch tensor."""
        self.sync()
        with self._lock:
            models = {}
            for name, svc in self._svcs.items():
                models[name] = {
                    "deadline_s": svc.deadline_s,
                    "backends": list(svc.backends),
                    "ladder": list(svc.ladder),
                    "n_submitted": svc.n_submitted,
                    "n_deferred": svc.n_deferred,
                    "last_deferred_rid": svc._last_deferred_rid,
                    "queue": [
                        {"rid": r.rid, "arrival": r.arrival,
                         "deadline": r.deadline,
                         "inputs": {k: np.asarray(v)
                                    for k, v in r.inputs.items()}}
                        for r in svc.queue],
                    "est_service": [[b, r, t] for (b, r), t
                                    in svc.est_service.items()],
                    "seeded": [[b, r] for (b, r) in sorted(svc._seeded)],
                    "rng": np.array(svc._rng, np.uint32),
                    "quarantined": sorted(svc.quarantined),
                }
            return {
                "version": 1,
                "flush_safety": self.flush_safety,
                "clock": self.clock,
                "pipeline": self.pipeline,
                "next_rid": self._next_rid,
                "rr": self._rr,
                "order": list(self._order),
                "models": models,
                "dispatches": [dataclasses.asdict(d)
                               for d in self.dispatches],
                "deferrals": [dataclasses.asdict(d)
                              for d in self.deferrals],
                "completions": [
                    {"rid": c.rid, "model": c.model, "kept": bool(c.kept),
                     "arrival": c.arrival, "finished": c.finished,
                     "rung": c.rung, "n_real": c.n_real,
                     "deadline": c.deadline}
                    for c in self.completions],
            }

    def load_state_dict(self, state: Dict) -> None:
        """Overlay a :meth:`state_dict` ledger onto a freshly constructed
        scheduler with the SAME models registered (same backends and
        ladders — validated): the reboot protocol is re-register from
        pristine plans, then restore. Restored completions carry their
        metadata with empty ``outputs`` (already delivered pre-reboot)."""
        if state.get("version") != 1:
            raise ValueError(
                f"unsupported scheduler checkpoint version "
                f"{state.get('version')!r}")
        with self._lock:
            if sorted(self._svcs) != sorted(state["models"]):
                raise ValueError(
                    f"checkpoint models {sorted(state['models'])} do not "
                    f"match registered models {sorted(self._svcs)}")
            for name, ms in state["models"].items():
                svc = self._svcs[name]
                if (list(svc.backends) != list(ms["backends"])
                        or list(svc.ladder) != list(ms["ladder"])):
                    raise ValueError(
                        f"checkpoint for {name!r} was taken with backends="
                        f"{ms['backends']} ladder={ms['ladder']}; "
                        f"re-register to match before restoring")
                svc.deadline_s = float(ms["deadline_s"])
                svc.n_submitted = int(ms["n_submitted"])
                svc.n_deferred = int(ms["n_deferred"])
                lr = ms["last_deferred_rid"]
                svc._last_deferred_rid = None if lr is None else int(lr)
                svc.queue.clear()
                for q in ms["queue"]:
                    svc.queue.append(Request(
                        int(q["rid"]), name,
                        {k: np.asarray(v) for k, v in q["inputs"].items()},
                        float(q["arrival"]), float(q["deadline"])))
                svc.est_service = {(str(b), int(r)): float(t)
                                   for b, r, t in ms["est_service"]}
                svc._seeded = {(str(b), int(r)) for b, r in ms["seeded"]}
                svc._rng = np.asarray(ms["rng"], dtype=np.uint32).copy()
                svc.quarantined = set(ms["quarantined"])
            self._next_rid = int(state["next_rid"])
            self._rr = int(state["rr"])
            self._order = list(state["order"])
            self.dispatches = [DispatchRecord(**d)
                               for d in state["dispatches"]]
            self.deferrals = [DeferralRecord(**d)
                              for d in state["deferrals"]]
            self.completions = [Completion(outputs={}, **c)
                                for c in state["completions"]]

    # -- asynchronous (wall-clock) mode -------------------------------------

    def start(self, poll_s: float = 0.001) -> None:
        """Run the dispatcher on a background thread against the wall
        clock; producers call :meth:`submit` concurrently."""
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stop.clear()
        self._thread_error = None

        def loop():
            while not self._stop.is_set():
                try:
                    rec = self.step(time.monotonic())
                except BaseException as ex:     # batch re-queued by step()
                    self._thread_error = ex
                    return
                if rec is None:
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="cb-scheduler")
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher thread; by default flush what's queued.
        Re-raises an error that killed the dispatcher (its batch was
        re-queued, so nothing was lost — but serving DID stop)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if self._thread_error is not None:
            err, self._thread_error = self._thread_error, None
            raise err
        if drain:
            self.drain(time.monotonic())    # drain() ends with sync()
        else:
            self.sync()

    # -- telemetry ----------------------------------------------------------

    def telemetry(self) -> Dict[str, ModelTelemetry]:
        self.sync()     # telemetry boundary: retire in-flight tickets first
        with self._lock:
            out: Dict[str, ModelTelemetry] = {}
            for name, svc in self._svcs.items():
                tel = ModelTelemetry(name, svc.deadline_s,
                                     n_submitted=svc.n_submitted)
                comps = [c for c in self.completions if c.model == name]
                # failed dispatches were requeued and re-dispatched: only
                # the records that actually produced completions count,
                # or the retried batch double-counts fill/energy/p99
                disps = [d for d in self.dispatches
                         if d.model == name and not d.failed]
                tel.n_failed_dispatches = sum(
                    1 for d in self.dispatches
                    if d.model == name and d.failed)
                tel.n_staging_fallbacks = sum(
                    p.arena.n_fallback
                    for rungs in svc.pipelines.values()
                    for p in rungs.values())
                tel.n_completed = len(comps)
                tel.n_kept = sum(c.kept for c in comps)
                tel.deadline_misses = sum(c.missed_deadline for c in comps)
                tel.n_dispatches = len(disps)
                span = ((max(c.finished for c in comps)
                         - min(c.arrival for c in comps)) if comps else 0.0)
                if comps:
                    lat = np.array([c.latency for c in comps])
                    tel.p50_latency_ms = float(np.percentile(lat, 50) * 1e3)
                    tel.p99_latency_ms = float(np.percentile(lat, 99) * 1e3)
                    tel.fps = len(comps) / max(span, 1e-12)
                if disps:
                    tel.mean_batch_fill = float(
                        np.mean([d.fill for d in disps]))
                    for rung in svc.ladder:
                        at = [d.fill for d in disps if d.rung == rung]
                        if at:
                            tel.fill_hist[rung] = {
                                "dispatches": len(at),
                                "mean_fill": float(np.mean(at))}
                    tel.energy_j = float(sum(d.energy_j for d in disps))
                    tel.j_per_inference = tel.energy_j / max(tel.n_completed,
                                                             1)
                    for d in disps:
                        tel.backend_counts[d.backend] = (
                            tel.backend_counts.get(d.backend, 0) + 1)
                    busy = sum(d.modeled_latency_s for d in disps)
                    tel.duty_cycle = busy / span if span > 0 else 0.0
                tel.n_deferrals = svc.n_deferred
                out[name] = tel
            return out

    def envelope_report(self) -> Optional[Dict]:
        """The envelope's ledger audit (None when serving unbudgeted):
        total J, duty cycle, max trailing-window W, and the violation
        count — which admission-time checking keeps at zero."""
        return None if self.envelope is None else self.envelope.audit()

    def overlap_report(self) -> Optional[Dict]:
        """The pipelined overlap ledger (None when pipeline=False):
        pipelined vs serialized makespan of the dispatched stage chains,
        the effective-throughput speedup, and per-resource occupancy.
        Deterministic and machine-independent under clock="modeled"."""
        return None if self.timeline is None else self.timeline.report()

    def summary(self) -> str:
        lines = []
        for name, tel in self.telemetry().items():
            lines.append(
                f"[{name}] {tel.n_completed}/{tel.n_submitted} served  "
                f"fps={tel.fps:.1f}  p50={tel.p50_latency_ms:.2f} ms  "
                f"p99={tel.p99_latency_ms:.2f} ms "
                f"(deadline {tel.deadline_s*1e3:.0f} ms, "
                f"{tel.deadline_misses} missed)  "
                f"fill={tel.mean_batch_fill:.0%} over {tel.n_dispatches} "
                f"dispatches  kept={tel.n_kept} "
                f"(downlink -{tel.downlink_reduction:.0%})")
            if tel.energy_j > 0:
                mix = " ".join(f"{b}:{c}" for b, c in
                               sorted(tel.backend_counts.items()))
                lines.append(
                    f"    energy={tel.energy_j:.4f} J "
                    f"({tel.j_per_inference*1e3:.4f} mJ/inf)  "
                    f"duty={tel.duty_cycle:.1%}  "
                    f"deferrals={tel.n_deferrals}  backends[{mix}]")
        rep = self.envelope_report()
        if rep is not None:
            lines.append(
                f"[envelope] {rep['total_j']:.4f} J over "
                f"{rep['n_draws']} draws  duty={rep['duty_cycle']:.1%}  "
                f"max-window={rep['max_window_w']:.2f} W  "
                f"violations={rep['n_violations']}")
        ov = self.overlap_report()
        if ov is not None and ov["n_dispatches"]:
            occ = " ".join(f"{r}:{o:.0%}" for r, o in
                           sorted(ov["occupancy"].items()))
            lines.append(
                f"[pipeline] modeled overlap {ov['overlap_speedup_x']:.2f}x "
                f"({ov['serial_span_s']:.4f} s serial -> "
                f"{ov['pipelined_span_s']:.4f} s pipelined over "
                f"{ov['n_dispatches']} dispatches)  occupancy[{occ}]")
        return "\n".join(lines)

# ---------------------------------------------------------------------------
# LM serving: the prefill/decode rung ladder
# ---------------------------------------------------------------------------
#
# Autoregressive decode is a different shape of workload from the frame
# stream above: a request is admitted ONCE (prefill — compute-bound, rides
# the same compiled batch-size ladder as the CNNs), then produces tokens
# over MANY small steps (decode — memory-bound, batched across every
# in-flight request at its KV slot). ``LMScheduler`` owns that loop:
#
# * prefill dispatches at the largest ladder rung the waiting queue
#   fills, flushing a ragged tail early when the oldest waiting request's
#   deadline slack falls under a safety margin of the estimated remaining
#   work (EWMA-measured prefill + per-token decode times) — the same
#   wait-to-fill / deadline-flush trade the frame scheduler makes;
# * decode steps batch ALL in-flight requests at the smallest decode rung
#   that holds them, padding dead lanes to the engine's scratch slot, so
#   rung programs are traced once and steady-state decode never re-traces
#   and never allocates (the LMEngine's n_traces / KVSlotAllocator
#   contract);
# * tokens stream out as they are produced (``TokenEvent`` carries a
#   wall timestamp), and telemetry reports tokens/s plus per-phase
#   latency percentiles — time-to-first-token, prefill service, decode
#   step — the serving numbers an on-board LM deployment is sized by.


@dataclasses.dataclass(frozen=True)
class LMRequest:
    rid: int
    x: np.ndarray                       # [S, D] prompt window
    deadline_s: float = 10.0            # completion deadline from submit
    max_new_tokens: int = 8             # tokens to generate (incl. first)


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token: emitted the moment its dispatch retires."""
    rid: int
    index: int                          # 0-based position in the response
    token: int
    time: float                         # wall perf_counter timestamp
    phase: str                          # 'prefill' (first token) | 'decode'


@dataclasses.dataclass(frozen=True)
class LMCompletion:
    rid: int
    tokens: Tuple[int, ...]
    submitted: float
    first_token_t: float
    finished: float
    deadline: float

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.submitted

    @property
    def latency_s(self) -> float:
        return self.finished - self.submitted

    @property
    def missed_deadline(self) -> bool:
        return self.finished > self.deadline


@dataclasses.dataclass
class _LMInflight:
    req: LMRequest
    slot: int
    hidden: np.ndarray                  # [D] feedback features
    tokens: List[int]
    submitted: float
    first_token_t: float


@dataclasses.dataclass
class LMTelemetry:
    n_submitted: int = 0
    n_completed: int = 0
    n_tokens: int = 0
    tokens_per_s: float = 0.0
    ttft_p50_ms: float = 0.0
    prefill_p50_ms: float = 0.0         # per-dispatch prefill service
    decode_step_p50_ms: float = 0.0     # per-dispatch decode service
    deadline_misses: int = 0
    n_prefill_dispatches: int = 0
    n_decode_dispatches: int = 0
    n_deadline_flushes: int = 0         # ragged prefills a deadline forced
    mean_prefill_fill: float = 0.0
    mean_decode_fill: float = 0.0
    n_slot_assigns: int = 0
    slot_high_water: int = 0
    n_traces: int = 0                   # steady-state serving: constant

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _p50(xs: List[float]) -> float:
    return float(np.percentile(xs, 50)) if xs else 0.0


class LMScheduler:
    """Prefill/decode scheduler over one :class:`~repro_torch.core.lm.LMEngine`.

    ``prefill_ladder`` rungs are compiled-plan batch sizes (capped at the
    engine's slot count — a prefill lane needs a slot); ``decode_ladder``
    rungs are decode-program widths. ``flush_margin`` scales the
    deadline-flush test: a ragged prefill dispatches once the oldest
    waiting request's slack drops under ``margin * estimated remaining
    work``.
    """

    def __init__(self, lm, prefill_ladder: Optional[Sequence[int]] = None,
                 decode_ladder: Optional[Sequence[int]] = None,
                 flush_margin: float = 2.0):
        self.lm = lm
        top = lm.n_slots
        self.prefill_ladder = tuple(
            prefill_ladder if prefill_ladder is not None
            else capped_ladder(top))
        self.decode_ladder = tuple(
            decode_ladder if decode_ladder is not None
            else capped_ladder(top, base=(1, 2, 4, 8, 16)))
        if max(self.prefill_ladder) > top:
            raise ValueError(
                f"prefill rung {max(self.prefill_ladder)} exceeds "
                f"{top} KV slot(s)")
        self.flush_margin = flush_margin
        self.waiting: Deque[Tuple[LMRequest, float]] = deque()
        self.inflight: List[_LMInflight] = []
        self.completions: List[LMCompletion] = []
        self.events: List[TokenEvent] = []
        # EWMA service estimates (seed pessimistically; first dispatches
        # correct them)
        self._prefill_ewma = 0.1
        self._decode_ewma = 0.02
        self._prefill_times: List[float] = []
        self._decode_times: List[float] = []
        self._prefill_fills: List[float] = []
        self._decode_fills: List[float] = []
        self._n_flushes = 0
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None

    # -- submission ----------------------------------------------------------

    def submit(self, req: LMRequest) -> None:
        if req.x.shape != (self.lm.seq_len, self.lm.d_model):
            raise ValueError(
                f"prompt window must be [{self.lm.seq_len}, "
                f"{self.lm.d_model}], got {req.x.shape}")
        if req.max_new_tokens > self.lm.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {req.max_new_tokens} exceeds the KV "
                f"plan's decode budget {self.lm.max_new_tokens}")
        self.waiting.append((req, time.perf_counter()))

    # -- scheduling core -----------------------------------------------------

    def _free_slots(self) -> int:
        return self.lm.n_slots - self.lm.slots.in_use

    def _rung(self, ladder: Sequence[int], n: int) -> int:
        """Smallest rung holding ``n`` (the largest rung caps n)."""
        for r in ladder:
            if r >= n:
                return r
        return max(ladder)

    def _urgent(self, now: float) -> bool:
        """Deadline-flush test on the oldest waiting request."""
        if not self.waiting:
            return False
        req, sub = self.waiting[0]
        remaining = (self._prefill_ewma
                     + req.max_new_tokens * self._decode_ewma)
        return (sub + req.deadline_s) - now < self.flush_margin * remaining

    def _should_prefill(self, now: float) -> bool:
        n_admit = min(len(self.waiting), self._free_slots())
        if n_admit == 0:
            return False
        if n_admit >= max(self.prefill_ladder):
            return True                 # a full top rung never waits
        if not self.inflight:
            return True                 # nothing else to run
        return self._urgent(now)        # ragged tail: only when forced

    def step(self) -> bool:
        """One scheduling decision (a prefill or a decode dispatch).
        Returns False when there is nothing left to do."""
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        if self._should_prefill(now):
            self._dispatch_prefill()
        elif self.inflight:
            self._dispatch_decode()
        elif self.waiting:
            # waiting requests but no free slot and nothing in flight
            # cannot happen (in-flight requests own the slots) — guard
            # against a stuck queue anyway
            raise RuntimeError("waiting requests with no runnable work")
        else:
            return False
        self._t_end = time.perf_counter()
        return True

    def run(self) -> List[LMCompletion]:
        """Drive to idle: serve every submitted request to completion."""
        while self.step():
            pass
        return self.completions

    # -- dispatches ----------------------------------------------------------

    def _dispatch_prefill(self) -> None:
        n_admit = min(len(self.waiting), self._free_slots())
        rung = self._rung(self.prefill_ladder, n_admit)
        n_real = min(n_admit, rung)
        batch: List[Tuple[LMRequest, float]] = [
            self.waiting.popleft() for _ in range(n_real)]
        slots = [self.lm.assign_slot(req.rid) for req, _ in batch]
        x = np.zeros((rung, self.lm.seq_len, self.lm.d_model), np.float32)
        slot_ids = np.full((rung,), self.lm.scratch_slot, np.int32)
        for i, (req, _) in enumerate(batch):
            x[i] = req.x
            slot_ids[i] = slots[i]
        t0 = time.perf_counter()
        res = self.lm.prefill(x, slot_ids)
        t1 = time.perf_counter()
        self._prefill_ewma = 0.7 * self._prefill_ewma + 0.3 * (t1 - t0)
        self._prefill_times.append(t1 - t0)
        self._prefill_fills.append(n_real / rung)
        if n_real < rung:
            self._n_flushes += 1
        for i, (req, sub) in enumerate(batch):
            tok = int(res.tokens[i])
            self.events.append(TokenEvent(req.rid, 0, tok, t1, "prefill"))
            fl = _LMInflight(req=req, slot=slots[i], hidden=res.hidden[i],
                             tokens=[tok], submitted=sub, first_token_t=t1)
            if req.max_new_tokens <= 1:
                self._retire(fl, t1)
            else:
                self.inflight.append(fl)

    def _dispatch_decode(self) -> None:
        rung = self._rung(self.decode_ladder, len(self.inflight))
        active = self.inflight[:rung]
        hidden = np.zeros((rung, self.lm.d_model), np.float32)
        slot_ids = np.full((rung,), self.lm.scratch_slot, np.int32)
        for i, fl in enumerate(active):
            hidden[i] = fl.hidden
            slot_ids[i] = fl.slot
        t0 = time.perf_counter()
        res = self.lm.decode_step(hidden, slot_ids)
        t1 = time.perf_counter()
        self._decode_ewma = 0.7 * self._decode_ewma + 0.3 * (t1 - t0)
        self._decode_times.append(t1 - t0)
        self._decode_fills.append(len(active) / rung)
        done: List[_LMInflight] = []
        for i, fl in enumerate(active):
            fl.tokens.append(int(res.tokens[i]))
            fl.hidden = res.hidden[i]
            self.events.append(TokenEvent(
                fl.req.rid, len(fl.tokens) - 1, fl.tokens[-1], t1,
                "decode"))
            if len(fl.tokens) >= fl.req.max_new_tokens:
                done.append(fl)
        for fl in done:
            self.inflight.remove(fl)
            self._retire(fl, t1)

    def _retire(self, fl: _LMInflight, t: float) -> None:
        self.lm.release_slot(fl.req.rid)
        self.completions.append(LMCompletion(
            rid=fl.req.rid, tokens=tuple(fl.tokens),
            submitted=fl.submitted, first_token_t=fl.first_token_t,
            finished=t, deadline=fl.submitted + fl.req.deadline_s))

    # -- reporting -----------------------------------------------------------

    def telemetry(self) -> LMTelemetry:
        tel = LMTelemetry()
        tel.n_submitted = (len(self.completions) + len(self.inflight)
                           + len(self.waiting))
        tel.n_completed = len(self.completions)
        tel.n_tokens = (sum(len(c.tokens) for c in self.completions)
                        + sum(len(f.tokens) for f in self.inflight))
        span = ((self._t_end or 0.0) - (self._t_start or 0.0))
        tel.tokens_per_s = tel.n_tokens / span if span > 0 else 0.0
        tel.ttft_p50_ms = _p50(
            [c.ttft_s for c in self.completions]) * 1e3
        tel.prefill_p50_ms = _p50(self._prefill_times) * 1e3
        tel.decode_step_p50_ms = _p50(self._decode_times) * 1e3
        tel.deadline_misses = sum(
            1 for c in self.completions if c.missed_deadline)
        tel.n_prefill_dispatches = len(self._prefill_times)
        tel.n_decode_dispatches = len(self._decode_times)
        tel.n_deadline_flushes = self._n_flushes
        tel.mean_prefill_fill = (float(np.mean(self._prefill_fills))
                                 if self._prefill_fills else 0.0)
        tel.mean_decode_fill = (float(np.mean(self._decode_fills))
                                if self._decode_fills else 0.0)
        tel.n_slot_assigns = self.lm.slots.n_assigns
        tel.slot_high_water = self.lm.slots.high_water
        tel.n_traces = self.lm.n_traces
        return tel

    def summary(self) -> str:
        tel = self.telemetry()
        return (
            f"[lm] {tel.n_completed}/{tel.n_submitted} served  "
            f"{tel.n_tokens} tokens @ {tel.tokens_per_s:.1f} tok/s  "
            f"ttft p50={tel.ttft_p50_ms:.2f} ms  "
            f"prefill p50={tel.prefill_p50_ms:.2f} ms  "
            f"decode-step p50={tel.decode_step_p50_ms:.2f} ms  "
            f"misses={tel.deadline_misses}\n"
            f"     {tel.n_prefill_dispatches} prefill "
            f"(fill={tel.mean_prefill_fill:.0%}, "
            f"{tel.n_deadline_flushes} deadline flushes) + "
            f"{tel.n_decode_dispatches} decode "
            f"(fill={tel.mean_decode_fill:.0%}) dispatches  "
            f"slots hw={tel.slot_high_water}/{self.lm.n_slots} "
            f"assigns={tel.n_slot_assigns}  traces={tel.n_traces}")
