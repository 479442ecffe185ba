"""Tracing of the served path: named host spans on the profiler's
timeline, and one record per dispatch.

Off by default. :func:`enable` turns it on for the device the served
engines run on and :func:`disable` turns it off; :func:`records` returns
the records made since the last :func:`reset`. While it is off, each call
site costs one check of the module global :data:`on` (a segment of the
plan then enters the shared empty context :data:`OFF`): no
``record_function``, no CUDA event, no clock read.

**Spans.** While tracing is on and a ``torch.profiler`` records on the
calling thread, each stage of a dispatch runs inside a
``record_function`` span, so the host's stages share the profiler's clock
with the device's events:

====================  =====================================================
``sched.step``        ``ContinuousBatchingScheduler.step``
``sched.pick``        its locked decision (queue, rung, backend)
``sched.idle``        the threaded loop after an empty poll: its sleep,
                      or its wait for the oldest dispatch in flight
``sched.complete``    retirement's bookkeeping after the ticket retired:
                      the service estimate, the record, the completions
``pipeline.stage``    ``ServingPipeline._stage``: host staging, the copy in
``plan.dispatch``     ``ServingPipeline._dispatch``: the plan's launches
``plan.accel``        one accel segment of the plan (``ExecutionPlan.
                      segments``): the int8 kernels and the ops beside them
``plan.flex``         one flex segment: library fp32 operations the int8
                      kernels do not run (3-D convolutions and pools, their
                      pads and permutes)
``pipeline.wait``     the host blocked until the dispatch's device work ended
``pipeline.unstage``  ``ServingPipeline._unstage``: the copy out
``pipeline.keep``     ``ServingPipeline._keep``: the keep predicate
====================  =====================================================

**Records.** Each dispatch staged while tracing is on leaves one
:class:`DispatchSpan` when it retires, its times in ``time.monotonic_ns``
(the scheduler's clock; add :func:`offset_ns` to place them on the wall
clock, which the profiler's timeline follows). The device's completion is
read without a new wait on the timed path: :func:`enable` records timing
events on a CUDA device and waits for them (the anchor); each dispatch
records one event right after its plan's last launch; at retirement the
host waits for that event before the copy out (which would wait for it
anyway), and ``done`` is the anchor's host time plus the device's time
between the two events. The card's timer and the host's clock drift apart
(up to 5 us a second on an H100, and not steadily), so the clock is
anchored again while the dispatcher idles and at :func:`disable`, and a
device time is mapped between the anchors around it. On the CPU ``done``
is the time the plan call returned.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import time
from typing import Callable, List, Optional, Tuple

import torch

on = False                              # read by every call site
_clock: Optional["_Clock"] = None       # of the last enable() on a card
_offset_ns = 0
_pool: List[torch.cuda.Event] = []      # events of retired dispatches
# (record, the clock of its ``done`` or None, device ns since its anchor)
_records: List[Tuple["DispatchSpan", Optional["_Clock"], float]] = []
OFF = contextlib.nullcontext()          # the span of a call site while off


@dataclasses.dataclass(frozen=True)
class DispatchSpan:
    """One dispatch's life, in ``time.monotonic_ns``."""
    rec_idx: Optional[int]  # index in the scheduler's ``dispatches``, the
                            # id its requests share; None from ``run()``
    model: str
    rung: int
    n_real: int
    started: int            # the scheduler step's ``now`` (stage0 in run())
    stage0: int             # ``_stage`` called
    stage1: int             # ``_stage`` returned
    launched: int           # ``_dispatch`` returned
    done: int               # the device finished the plan's last operation
    retire0: int            # the ticket's retirement began
    retired: int            # the completions were appended
    cause: Optional[str]    # why it retired: 'done' (its device work had
                            # finished), 'slot' (a later dispatch needed
                            # its staging slot) or 'sync'; None from run()


def _synced_anchor(tries: int = 8) -> Tuple[torch.cuda.Event, int]:
    """An event and the host's time at it. The host wakes from a wait up
    to tens of us late, so of ``tries`` events recorded and waited for back
    to back, the one it saw soonest sets the time."""
    first, best = None, None
    for _ in range(tries):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        host = time.monotonic_ns()
        if first is None:
            first = ev
        host -= round(first.elapsed_time(ev) * 1e6)
        best = host if best is None else min(best, host)
    return first, best


class _Clock:
    """A card's event times on the host's monotonic clock. The card's timer
    and the host's clock drift apart, by up to several us a second and not
    steadily, so the clock keeps anchors (an event's device time and the
    host's time at it) and maps a device time between the anchors around
    it; past the last one it keeps that anchor's offset. Anchors are taken
    at :func:`enable` and :func:`disable` (events waited for) and, at most
    once a second, while the dispatcher idles (an event polled for at most
    ``POLL_NS``, never waited for)."""
    EVERY_NS = 1_000_000_000            # between idle anchors
    RETRY_NS = 100_000_000              # after a poll the card kept busy
    POLL_NS = 50_000

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.ref, host = _synced_anchor()
        self.dev, self.hosts = [0.0], [host]
        self.next_poll = host + self.EVERY_NS
        self.closed = False

    def since(self, ev: torch.cuda.Event) -> float:
        """Device ns from the first anchor to ``ev``."""
        return self.ref.elapsed_time(ev) * 1e6

    def add(self, ev: torch.cuda.Event, host: int) -> None:
        self.dev.append(self.since(ev))
        self.hosts.append(host)

    def poll(self) -> None:
        """The event completes after the host issues it and before a query
        sees it, and after the last query that did not: the middle of the
        narrowest such bracket, if under ``POLL_NS / 5``, is an anchor."""
        now = time.monotonic_ns()
        if now < self.next_poll:
            return
        self.next_poll = now + self.RETRY_NS
        stream = torch.cuda.current_stream(self.device)
        ev = torch.cuda.Event(enable_timing=True)
        lo = time.monotonic_ns()
        ev.record(stream)
        while True:
            before = time.monotonic_ns()
            seen = ev.query()
            hi = time.monotonic_ns()
            if seen:
                break
            lo = before
            if hi - now > self.POLL_NS:
                return
        if hi - lo < self.POLL_NS // 5:     # no thread switch in between
            self.add(ev, (lo + hi) // 2)
            self.next_poll = hi + self.EVERY_NS

    def close(self) -> None:
        with torch.cuda.device(self.device):
            self.add(*_synced_anchor())
        self.closed = True

    def host(self, dev_ns: float) -> int:
        i = max(bisect.bisect_right(self.dev, dev_ns), 1)
        if i == len(self.dev):
            return self.hosts[-1] + round(dev_ns - self.dev[-1])
        d0, d1 = self.dev[i - 1], self.dev[i]
        h0, h1 = self.hosts[i - 1], self.hosts[i]
        return h0 + round((dev_ns - d0) * (h1 - h0) / (d1 - d0))


class Draft:
    """The times of one dispatch in flight; a ticket carries it from
    staging to retirement, where :func:`finish` freezes it."""
    __slots__ = ("stage0", "stage1", "launched", "done", "retire0",
                 "dev_ns", "_event", "_clock", "_stream")

    def __init__(self):
        self.stage0 = time.monotonic_ns()
        self.stage1 = self.launched = self.done = self.retire0 = 0
        self.dev_ns = 0.0
        self._event = None
        self._clock = _clock
        # the dispatching thread's stream, read here rather than in mark()
        self._stream = (None if _clock is None
                        else torch.cuda.current_stream(_clock.device))

    def mark(self) -> None:
        """The plan's last launch is issued: mark the device's stream."""
        if self._clock is not None:
            self._event = _pool.pop() if _pool else torch.cuda.Event(
                enable_timing=True)
            self._event.record(self._stream)

    def wait(self) -> None:
        """Retirement began: block until the dispatch's device work has
        ended, and read when it did."""
        self.retire0 = time.monotonic_ns()
        ev = self._event
        if ev is None:
            self.done = self.launched
            return
        with span("pipeline.wait"):
            ev.synchronize()
        self.dev_ns = self._clock.since(ev)
        self.done = self._clock.host(self.dev_ns)
        self._event = None
        _pool.append(ev)


def enable(device) -> None:
    """Turn tracing on for engines on ``device``. On a CUDA device this
    takes the first anchor."""
    global on, _clock, _offset_ns
    dev = torch.device(device)
    _pool.clear()
    _clock = _Clock(dev) if dev.type == "cuda" else None
    _offset_ns = time.time_ns() - time.monotonic_ns()
    on = True


def disable() -> None:
    """Turn tracing off (on a CUDA device, after a last anchor); dispatches
    in flight still leave their records."""
    global on
    on = False
    if _clock is not None and not _clock.closed:
        _clock.close()


def idle() -> None:
    """The dispatcher found nothing to do: a chance to re-anchor the card's
    clock."""
    if on and _clock is not None:
        _clock.poll()


def records() -> List[DispatchSpan]:
    """The records since the last :func:`reset`, in retirement order; a
    card's ``done`` is mapped by every anchor taken so far."""
    return [s if c is None else dataclasses.replace(s, done=c.host(d))
            for s, c, d in _records]


def reset() -> None:
    _records.clear()


def offset_ns() -> int:
    """``time.time_ns() - time.monotonic_ns()`` at :func:`enable`: added to
    a record's times, it places them on the wall clock, which the
    profiler's timeline follows (to within its own conversion, tens of
    us)."""
    return _offset_ns


def finish(draft: Draft, rec_idx: Optional[int], model: str, rung: int,
           n_real: int, started: Optional[float] = None,
           cause: Optional[str] = None) -> None:
    """Freeze a retired dispatch's draft into its record; ``started`` is
    the scheduler's ``now`` in seconds, ``cause`` why it retired."""
    rec = DispatchSpan(
        rec_idx, model, rung, n_real,
        draft.stage0 if started is None else round(started * 1e9),
        draft.stage0, draft.stage1, draft.launched, draft.done,
        draft.retire0, time.monotonic_ns(), cause)
    _records.append((rec, draft._clock, draft.dev_ns))


def span(name: str):
    """The span ``name`` while tracing is on and a profiler records on
    this thread, else a context that does nothing."""
    if on and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return OFF


def traced(name: str) -> Callable:
    """Run a method inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
