"""Batched on-board serving pipeline.

The paper's PYNQ flow is load_ip_input() -> start_ip() -> read_ip_output().
This pipeline reproduces that phase structure with a pool of reusable host
staging buffers (batch k+1 is assembled while batch k computes), dispatch
tickets riding CUDA's asynchronous stream, and micro-batching; its stages
carry the spans and per-dispatch records of ``core/spans.py`` while
tracing is on. It also implements the use cases' selective downlink:
requests whose output passes the keep predicate are kept, the rest
dropped, and the downlink reduction is reported.

``ServingPipeline`` is the single-model, single-batch-size core: one
compiled plan, one padded batch per call. The scheduler composes one per
ladder rung and drives :meth:`execute_batch` (or
:meth:`execute_batch_async` in pipelined mode).

Synchronization: no path calls ``torch.cuda.synchronize``. Each dispatch
on a card records a completion probe (a plain CUDA event) right after the
plan's last launch; :meth:`DispatchTicket.done` queries it, so a caller can
retire a ticket as soon as the card has finished it. A dispatch's outputs
are copied to the host — which waits for exactly that batch's work on the
stream — when its :class:`DispatchTicket` retires (traced, the host first
waits for the dispatch's own timing event).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, List, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.core import memory as memory_mod
from repro_torch.core import spans
from repro_torch.kernels.sample import split


def split_seeds(seed: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.split`` of the raw key ``seed`` [2] into ``n`` keys
    [n, 2] uint32 (threefry-2x32, ``kernels/sample.py: split``), so a
    served batch draws the reference's per-sample keys."""
    return split(seed, n).astype(np.uint32)


@dataclasses.dataclass
class ServeStats:
    n_requests: int
    n_kept: int
    fps: float

    @property
    def downlink_reduction(self) -> float:
        return 1.0 - self.n_kept / max(self.n_requests, 1)


@dataclasses.dataclass
class BatchResult:
    """One dispatched batch: host outputs sliced back to the real requests
    and the per-request keep verdicts; ``span`` holds its times while
    tracing is on."""
    outputs: Dict[str, np.ndarray]      # [n_real, ...] — padding sliced off
    keep: List[bool]                    # per real request
    span: Optional[spans.Draft] = None

    @property
    def n_kept(self) -> int:
        return sum(self.keep)


def stage_batch(reqs: List[Dict[str, np.ndarray]], batch_size: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Stack request dicts into one ``[batch_size, ...]`` device batch,
    padding a ragged tail by repeating the last sample (the padding rows
    are sliced off after compute). The freshly-allocating fallback of the
    arena staging path, and the reference its bit-exactness is tested
    against."""
    if not reqs:
        raise ValueError("stage_batch needs at least one request")
    if len(reqs) > batch_size:
        raise ValueError(f"{len(reqs)} requests > batch size {batch_size}")
    batch = {k: np.stack([np.asarray(r[k], np.float32) for r in reqs])
             for k in reqs[0]}
    if len(reqs) < batch_size:             # pad the ragged tail
        pad = batch_size - len(reqs)
        batch = {k: np.concatenate(
            [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class HostStagingArena:
    """The pool of reusable host batch buffers a :class:`StagingPlan`
    sizes: ``slots`` preallocated fp32 ``[B, ...]`` buffers per graph
    input, filled in place per dispatch. For a CUDA device the buffers are
    pinned, so the host-to-device copy is asynchronous.

    Ownership: ``acquire()`` hands a slot to the dispatch being staged; it
    returns to the pool only when that dispatch's ticket retires, after
    which the copy out of it has completed. ``stage()`` writes every row
    (real rows then ragged padding), so reuse cannot leak a previous
    batch's samples."""

    def __init__(self, staging: memory_mod.StagingPlan,
                 device: torch.device):
        self.staging = staging
        pin = device.type == "cuda"
        self._bufs = [
            {k: torch.empty(shape, dtype=torch.float32, pin_memory=pin)
             for k, shape in staging.input_shapes.items()}
            for _ in range(staging.slots)]
        self._free: Deque[int] = deque(range(staging.slots))
        self.n_staged = 0           # dispatches staged through a slot
        self.n_fallback = 0         # pool-exhausted fresh allocations

    @property
    def n_slots(self) -> int:
        return self.staging.slots

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        """Take a free slot (None when the pool is exhausted — callers
        fall back to a fresh `stage_batch` allocation, never deadlock)."""
        return self._free.popleft() if self._free else None

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def stage(self, slot: int, reqs: List[Dict[str, np.ndarray]]
              ) -> Dict[str, torch.Tensor]:
        """Fill ``slot`` in place with ``reqs`` (+ repeat-last padding);
        returns the slot's host buffers. Bit-identical to `stage_batch`."""
        n = len(reqs)
        bufs = self._bufs[slot]
        for k, buf in bufs.items():
            host = buf.numpy()
            for i, r in enumerate(reqs):
                host[i] = np.asarray(r[k], np.float32)
            if n < self.staging.batch_size:
                host[n:] = host[n - 1]
        self.n_staged += 1
        return bufs


@dataclasses.dataclass
class DispatchTicket:
    """One in-flight dispatched batch: device outputs not yet copied back,
    plus the staging slot the dispatch owns. ``retire()`` copies the
    outputs to the host (waiting for exactly this batch), runs the keep
    predicate, releases the slot, and returns the :class:`BatchResult`.
    Idempotent. If retirement raises, the slot is still released and the
    ticket is poisoned: a later ``retire()`` raises RuntimeError."""
    pipeline: "ServingPipeline"
    outputs: Optional[Dict[str, torch.Tensor]]
    n_real: int
    slot: Optional[int]
    span: Optional[spans.Draft] = None
    probe: Optional[torch.cuda.Event] = None    # None on the CPU
    _result: Optional[BatchResult] = None

    @property
    def retired(self) -> bool:
        return self._result is not None

    def done(self) -> bool:
        """Whether the dispatch's device work has finished, without
        waiting. Always true on the CPU, where the plan call returns when
        its work has."""
        probe = self.probe
        return probe is None or probe.query()

    def wait(self) -> None:
        """Block until the dispatch's device work has finished (the GIL is
        released meanwhile); nothing is copied or retired."""
        probe = self.probe
        if probe is not None:
            probe.synchronize()

    def _release(self) -> None:
        if self.slot is not None:
            self.pipeline.arena.release(self.slot)
            self.slot = None
        if self.probe is not None:
            self.pipeline._probes.append(self.probe)
            self.probe = None
        try:
            self.pipeline._inflight.remove(self)
        except ValueError:
            pass

    def retire(self) -> BatchResult:
        if self._result is not None:
            return self._result
        if self.outputs is None:
            raise RuntimeError(
                "retire() after a failed retirement: this ticket's batch "
                "was already abandoned (its outputs are gone)")
        try:
            if self.span is not None:
                self.span.wait()
            host_out = self.pipeline._unstage(self.outputs, self.n_real)
            keep = self.pipeline._keep(host_out, self.n_real)
        except BaseException:
            self.outputs = None         # poison: no result can ever exist
            self._release()
            raise
        self.outputs = {}               # drop the device references
        self._release()
        self._result = BatchResult(host_out, keep, self.span)
        return self._result


class ServingPipeline:
    """Micro-batched, pipelined inference over a request stream: one
    compiled batched program per (backend, batch_size), built up front.
    Ragged final chunks are padded up to the batch size (and the padding
    sliced off). ``staging_buffers`` sizes the host staging arena."""

    def __init__(self, engine, backend: str = "flex",
                 batch_size: int = 16,
                 keep_predicate: Optional[Callable] = None,
                 staging_buffers: int = 2):
        self.engine = engine
        self.backend = backend
        self.batch_size = batch_size
        self.keep_predicate = keep_predicate
        self.device = engine.device
        self._plan = engine.compile(backend, batch_size)
        self.staging = memory_mod.plan_staging(
            self._plan.plan.graph, batch_size, staging_buffers)
        self.arena = HostStagingArena(self.staging, self.device)
        self._inflight: Deque[DispatchTicket] = deque()
        self._probes: List[torch.cuda.Event] = []  # of retired dispatches

    @property
    def cost(self):
        """The compiled plan's plan-time cost signature."""
        return self._plan.cost

    @property
    def stages(self):
        """The plan's pipeline-stage decomposition."""
        return self._plan.stages

    @spans.traced("pipeline.stage")
    def _stage(self, reqs: List[Dict[str, np.ndarray]]
               ) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
        """Stage one batch into an arena slot, falling back to a fresh
        `stage_batch` allocation when the pool is dry. Returns (device
        batch, owned slot or None)."""
        if not reqs:
            raise ValueError("stage_batch needs at least one request")
        if len(reqs) > self.batch_size:
            raise ValueError(
                f"{len(reqs)} requests > batch size {self.batch_size}")
        slot = self.arena.acquire()
        if slot is None:
            self.arena.n_fallback += 1
            return stage_batch(reqs, self.batch_size, self.device), None
        host = self.arena.stage(slot, reqs)
        return ({k: v.to(self.device, non_blocking=True)
                 for k, v in host.items()}, slot)

    @spans.traced("plan.dispatch")
    def _dispatch(self, staged: Dict[str, torch.Tensor], rng: np.ndarray,
                  mark: Optional[Callable[[], None]] = None
                  ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
        """One plan call, nothing waited for; returns (device outputs,
        carried-over seed). ``mark`` marks the device's stream right after
        the plan's last launch: the host's own tail after it (tens of us,
        more under a profiler) is not the device's work."""
        seeds = split_seeds(rng, self.batch_size + 1)
        rngs = torch.from_numpy(seeds[1:].astype(np.int64))
        if mark is None:
            return self._plan(staged, rngs), seeds[0]
        return self._plan(staged, rngs, mark), seeds[0]

    def _marker(self, draft: Optional[spans.Draft]
                ) -> Tuple[Optional[torch.cuda.Event],
                           Optional[Callable[[], None]]]:
        """A dispatch's completion probe (None on the CPU) and the mark
        that records it, after the traced draft's own timing event, on
        the dispatching thread's stream."""
        if self.device.type != "cuda":
            return None, (None if draft is None else draft.mark)
        probe = self._probes.pop() if self._probes else torch.cuda.Event()
        stream = torch.cuda.current_stream(self.device)

        def mark() -> None:
            if draft is not None:
                draft.mark()
            probe.record(stream)
        return probe, mark

    def _submit(self, reqs: List[Dict[str, np.ndarray]], rng: np.ndarray
                ) -> Tuple[DispatchTicket, np.ndarray]:
        """Stage and dispatch one batch; returns (ticket, carried-over
        seed)."""
        draft = spans.Draft() if spans.on else None
        staged, slot = self._stage(reqs)
        if draft is not None:
            draft.stage1 = time.monotonic_ns()
        probe, mark = self._marker(draft)
        try:
            out, carry = self._dispatch(staged, rng, mark)
        except BaseException:
            if slot is not None:        # dispatch failed: slot back to pool
                self.arena.release(slot)
            if probe is not None:
                self._probes.append(probe)
            raise
        if draft is not None:
            draft.launched = time.monotonic_ns()
        ticket = DispatchTicket(self, out, len(reqs), slot, draft, probe)
        self._inflight.append(ticket)
        return ticket, carry

    @spans.traced("pipeline.unstage")
    def _unstage(self, out: Dict[str, torch.Tensor], n_real: int
                 ) -> Dict[str, np.ndarray]:
        return {k: v[:n_real].cpu().numpy() for k, v in out.items()}

    @spans.traced("pipeline.keep")
    def _keep(self, host_out: Dict[str, np.ndarray], n_real: int
              ) -> List[bool]:
        if self.keep_predicate is None:
            return [True] * n_real
        return [bool(self.keep_predicate({k: v[i] for k, v in host_out.items()}))
                for i in range(n_real)]

    # -- the scheduler's dispatch core --------------------------------------

    def execute_batch_async(self, reqs: List[Dict[str, np.ndarray]],
                            rng: Optional[np.ndarray] = None
                            ) -> DispatchTicket:
        """Stage + dispatch ONE (possibly ragged) batch without waiting for
        it; the returned ticket owns the staging slot until `retire()`."""
        if rng is None:
            rng = np.zeros(2, np.uint32)
        return self._submit(reqs, rng)[0]

    def execute_batch(self, reqs: List[Dict[str, np.ndarray]],
                      rng: Optional[np.ndarray] = None) -> BatchResult:
        """Serve exactly ONE (possibly ragged) batch and return its
        result: stage + pad -> compiled plan -> slice padding -> keep
        predicate."""
        return self.execute_batch_async(reqs, rng=rng).retire()

    def sync(self) -> None:
        """Retire every in-flight ticket."""
        while self._inflight:
            self._inflight[0].retire()

    # -- standalone fixed-batch streaming mode ------------------------------

    def run(self, requests: Iterable[Dict[str, np.ndarray]],
            pipeline: bool = True) -> ServeStats:
        """Stream ``requests`` through fixed-size batches. ``pipeline=True``
        stages and dispatches batch k+1 while batch k runs, retiring
        tickets when the slot pool runs dry and at stream end;
        ``pipeline=False`` retires each batch before the next."""
        reqs = list(requests)
        if not reqs:                        # empty stream: zero-request stats
            return ServeStats(n_requests=0, n_kept=0, fps=0.0)
        kept = 0
        rng = np.zeros(2, np.uint32)
        batches = [reqs[i:i + self.batch_size]
                   for i in range(0, len(reqs), self.batch_size)]

        tickets: Deque[DispatchTicket] = deque()

        def _retire_next() -> None:
            nonlocal kept
            res = tickets.popleft().retire()
            kept += sum(res.keep)
            if res.span is not None:
                spans.finish(res.span, None, self.engine.graph.name,
                             self.batch_size, len(res.keep))

        wall0 = time.perf_counter()
        for chunk in batches:
            if pipeline:
                while tickets and self.arena.n_free == 0:
                    _retire_next()
            ticket, rng = self._submit(chunk, rng)
            tickets.append(ticket)
            if not pipeline:
                _retire_next()
        while tickets:                      # stream-end flush
            _retire_next()
        wall = time.perf_counter() - wall0
        fps = len(reqs) / max(wall, 1e-12)
        return ServeStats(n_requests=len(reqs), n_kept=kept, fps=fps)
