"""The traced stretch of a ``--trace 1`` run, and its reduction.

:class:`Tracer` wraps the scheduler's ``step`` so that the profiler
starts and stops on the dispatcher thread, which issues every device
operation (the profiler's CPU callbacks are per thread); CUDA activity is
recorded for the whole process. While it records, the stages of each
dispatch carry spans named after the layer they call into
(``sched.step``, ``pipeline.stage``, ``plan.dispatch``,
``pipeline.unstage``, ``pipeline.keep``), which name what the host was
doing in each of the device's idle gaps.

:func:`reduce` turns the profiler's events into plain records
(:class:`TraceData`) that the metric readers take; the readers and the
tests never touch a profiler object.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

IDLE_LABEL = "no span: dispatcher polling or between calls"


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    kind: str           # kernel | h2d | d2h | d2d | memset
    start_ns: int
    dur_ns: int

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns


@dataclasses.dataclass(frozen=True)
class HostSpan:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class TraceData:
    device: List[DeviceEvent]
    spans: List[HostSpan]
    wall_s: float                       # the traced stretch, host clock
    rungs: List[Tuple[int, int]]        # (rung, n_real) per dispatch in it

    @property
    def n_dispatches(self) -> int:
        return len(self.rungs)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device)) / 1e9


def kind_of(name: str) -> str:
    if "Memcpy HtoD" in name:
        return "h2d"
    if "Memcpy DtoH" in name:
        return "d2h"
    if "Memcpy" in name:
        return "d2d"
    if "Memset" in name:
        return "memset"
    return "kernel"


def merged(events: List[DeviceEvent]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, as sorted disjoint pairs."""
    out: List[List[int]] = []
    for s, e in sorted((ev.start_ns, ev.end_ns) for ev in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def breakdown(data: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the device's idle
    time between its first and last operation, by the innermost span the
    host was in at each gap's midpoint."""
    by_op: Dict[str, int] = {}
    for ev in data.device:
        by_op[ev.name] = by_op.get(ev.name, 0) + ev.dur_ns
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(data.spans, key=lambda s: s.start_ns)
    idle: Dict[str, int] = {}
    busy = merged(data.device)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        inner = [s for s in spans if s.start_ns <= mid <= s.end_ns]
        label = (max(inner, key=lambda s: s.start_ns).name if inner
                 else IDLE_LABEL)
        idle[label] = idle.get(label, 0) + (s1 - e0)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def reduce(prof, start_ns: int, end_ns: int, wall_s: float,
           rungs: List[Tuple[int, int]], labels: Set[str]) -> TraceData:
    """Plain records from a stopped ``torch.profiler.profile``, clipped to
    the stretch ``[start_ns, end_ns]`` of the profiler's clock (the host's
    wall clock in ns); host events named by ``labels`` are the spans. The
    spans' own annotations on the device timeline are left out: they are
    not device work."""
    import torch
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        s, e = max(start, start_ns), min(end, end_ns)
        if e < s or (e == s and end > start):
            continue
        if name in labels:
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append(HostSpan(name, s, e))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(DeviceEvent(name, kind_of(name), s, e - s))
    return TraceData(device, spans, wall_s, rungs)


@dataclasses.dataclass
class Hooks:
    """What a served system lets a :class:`Tracer` wrap and slice.

    ``step`` is ``(object, method name)``: the call that issues every
    device operation, made again and again while the system serves, idle
    or not. On the thread for which ``on_thread()`` is true the profiler
    starts and stops inside it, and while the profiler records
    each such call is a span named ``step_label``. ``spans`` are further
    ``(object, method name, label)`` calls that are spans while it
    records. ``dispatches()`` returns the system's dispatch records so far
    (each with ``rung`` and ``n_real``), which the Tracer slices to the
    traced stretch."""
    step: Tuple[Any, str]
    step_label: str
    on_thread: Callable[[], bool]
    spans: List[Tuple[Any, str, str]]
    dispatches: Callable[[], list]

    @property
    def labels(self) -> Set[str]:
        return {self.step_label} | {label for _, _, label in self.spans}


class Tracer:
    """Profiles one stretch of the window, from :meth:`request_start` (the
    system's next step on its dispatching thread starts the profiler) to
    :meth:`mark_end` (the window's close). The profiler stops at
    :meth:`request_stop`, after the window, so that reading out its events
    holds up nothing the window measures."""

    def __init__(self, system):
        import torch
        self._torch = torch
        self.hooks = hooks = system.trace_hooks()
        self._want: Optional[str] = None
        self._lock = threading.Lock()
        self.prof = None
        self.active = False
        self.started = threading.Event()
        self.done = threading.Event()
        self.t_start = self.t_end = 0.0
        self.ns_start = self.ns_end = 0
        self.d_start = self.d_end = 0
        rf = torch.profiler.record_function
        obj, attr = hooks.step
        orig = getattr(obj, attr)

        def step(*args, **kwargs):
            if not hooks.on_thread():
                return orig(*args, **kwargs)
            self._poll()
            if not self.active:
                return orig(*args, **kwargs)
            with rf(hooks.step_label):
                return orig(*args, **kwargs)

        setattr(obj, attr, step)
        for obj, attr, label in hooks.spans:
            setattr(obj, attr, self._span(getattr(obj, attr), label, rf))

    def _span(self, fn: Callable, label: str, rf) -> Callable:
        def wrapped(*a, **k):
            if not self.active:
                return fn(*a, **k)
            with rf(label):
                return fn(*a, **k)
        return wrapped

    def request_start(self) -> None:
        self._want = "start"

    def mark_end(self) -> None:
        if self.started.is_set() and not self.ns_end:
            self.ns_end = time.time_ns()
            self.t_end = time.monotonic()
            self.d_end = len(self.hooks.dispatches())

    def request_stop(self) -> None:
        with self._lock:
            self.mark_end()
            if self.prof is None:       # never started: nothing to stop
                self._want = None
                self.done.set()
            else:
                self._want = "stop"

    def _poll(self) -> None:
        with self._lock:
            self._step_state()

    def _step_state(self) -> None:
        prof_mod = self._torch.profiler
        if self._want == "start" and self.prof is None:
            self._want = None
            acts = [prof_mod.ProfilerActivity.CPU]
            if self._torch.cuda.is_available():
                acts.append(prof_mod.ProfilerActivity.CUDA)
            self.prof = prof_mod.profile(activities=acts)
            self.prof.start()
            self.ns_start = time.time_ns()
            self.t_start = time.monotonic()
            self.d_start = len(self.hooks.dispatches())
            self.active = True
            self.started.set()
        elif self._want == "stop" and self.active:
            self._want = None
            self.prof.stop()
            self.active = False
            self.done.set()

    def data(self) -> TraceData:
        recs = self.hooks.dispatches()[self.d_start:self.d_end]
        return reduce(self.prof, self.ns_start, self.ns_end,
                      self.t_end - self.t_start,
                      [(r.rung, r.n_real) for r in recs], self.hooks.labels)


def warm_profiler() -> None:
    """Start and stop the profiler once, so that the device tracer's own
    start-up happens in set-up and not inside the window."""
    import torch
    prof_mod = torch.profiler
    with prof_mod.profile(activities=[prof_mod.ProfilerActivity.CPU,
                                      prof_mod.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
