"""The served path's tracing (``core/spans.py``): off by default and then
without effect; on, one record per dispatch with its times in order, and
spans on the profiler's timeline. On the card (``-m gpu``) each record's
device completion is held to the profiler's own timeline.

Imports nothing of the JAX reference, so it runs on the GPU machine:

    python -m pytest -m gpu -s tests/test_torch_spans.py
"""
import bisect
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import spans
from repro_torch.core.engine import Engine
from repro_torch.core.pipeline import ServingPipeline
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        poisson_arrivals)
from repro_torch.models import cnet_plus_scalar as tcnet

NARROW = dict(input_shape=(32, 32, 2), channels=(8, 8, 4), dense=12)
MODEL = "cnet_plus_scalar"


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no records."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def engine():
    e = Engine(tcnet.build_graph(**NARROW), tcnet.init_params(3, **NARROW),
               device="cpu")
    e.calibrate(_requests(4, seed=3))
    return e


def _requests(n, seed, shape=NARROW["input_shape"]):
    rng = np.random.default_rng(seed)
    return [tcnet.synthetic_input(rng, shape) for _ in range(n)]


def _modeled_run(engine, reqs):
    s = ContinuousBatchingScheduler(clock="modeled", pipeline=True)
    s.register(MODEL, engine, backend="accel", ladder=(1, 4),
               deadline_s=0.004)
    times = poisson_arrivals(900.0, len(reqs), seed=3)
    s.serve_trace([(t, MODEL, r) for t, r in zip(times, reqs)])
    return s


def _counting_record_function(monkeypatch):
    names = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        names.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return names


def test_tracing_off_records_nothing_and_changes_nothing(engine,
                                                         monkeypatch):
    """Off (the default), a profiled run opens no span and makes no record
    or timestamp; on, the same trace gives the same dispatches and outputs
    and opens the path's spans."""
    assert spans.on is False
    reqs = _requests(11, seed=5)
    names = _counting_record_function(monkeypatch)
    real_draft = spans.Draft

    def no_draft():
        raise AssertionError("a dispatch was timed with tracing off")

    monkeypatch.setattr(spans, "Draft", no_draft)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        off = _modeled_run(engine, reqs)
    assert names == [] and spans.records() == []
    monkeypatch.setattr(spans, "Draft", real_draft)

    spans.enable("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _modeled_run(engine, reqs)
    spans.disable()
    assert [dataclasses.asdict(d) for d in on.dispatches] == [
        dataclasses.asdict(d) for d in off.dispatches]
    by_rid = {c.rid: c for c in off.completions}
    for c in on.completions:
        np.testing.assert_array_equal(c.outputs["head"],
                                      by_rid[c.rid].outputs["head"])
    assert set(names) == {"sched.step", "sched.pick", "sched.complete",
                          "pipeline.stage", "plan.dispatch", "plan.accel",
                          "pipeline.unstage", "pipeline.keep"}
    assert len(spans.records()) == len(on.dispatches) > 2


@pytest.mark.parametrize("pipelined", [True, False])
def test_traced_threaded_run_records_each_dispatch(engine, pipelined):
    """The ``start()/submit()/stop()`` path, pipelined or not: one record
    per dispatch, keyed by its index in ``sched.dispatches``, times in
    order."""
    s = ContinuousBatchingScheduler(pipeline=pipelined)
    s.register(MODEL, engine, backend="accel", ladder=(1, 4),
               deadline_s=0.05, warmup_sample=_requests(1, seed=1)[0])
    spans.enable("cpu")
    s.start(poll_s=0.0005)
    for r in _requests(9, seed=9):
        s.submit(MODEL, r)
        time.sleep(0.002)
    t_end = time.monotonic() + 30
    while s.pending() and time.monotonic() < t_end:
        time.sleep(0.005)
    s.stop()
    spans.disable()
    assert s.pending() == 0
    recs = spans.records()
    live = [i for i, d in enumerate(s.dispatches) if not d.failed]
    assert sorted(r.rec_idx for r in recs) == live and len(live) >= 3
    for r in recs:
        d = s.dispatches[r.rec_idx]
        assert (r.model, r.rung, r.n_real) == (d.model, d.rung, d.n_real)
        assert abs(r.started - d.started * 1e9) < 1e3
        assert (r.started <= r.stage0 <= r.stage1 <= r.launched <= r.done
                ), r
        assert r.retire0 <= r.retired, r
        assert r.done == r.launched     # the CPU: the plan call's return
        # the CPU's work is finished when the plan call returns, so the
        # pipelined dispatcher retires each dispatch at once
        assert r.cause == ("done" if pipelined else "sync"), r
    assert sum(r.n_real for r in recs) == 9


def test_standalone_run_records_each_batch(engine):
    pipe = ServingPipeline(engine, "accel", batch_size=4)
    spans.enable("cpu")
    assert pipe.run(_requests(10, seed=4)).n_requests == 10
    spans.disable()
    recs = spans.records()
    assert [r.n_real for r in recs] == [4, 4, 2]
    for r in recs:
        assert (r.rec_idx, r.model, r.rung, r.cause) == (None, MODEL, 4,
                                                          None)
        assert r.started == r.stage0 <= r.stage1 <= r.launched <= r.done
        assert r.done <= r.retire0 <= r.retired


def test_plan_segments_carry_their_spans():
    """The MMS BaselineNet on ``accel`` (3-D convs and pools on flex
    segments between accel ones), one B=4 dispatch profiled on the CPU:
    with tracing on, one ``plan.flex`` or ``plan.accel`` span a segment,
    in the plan's segment order; off, none; the outputs bit-identical
    either way."""
    from repro_torch.models import mms
    e = Engine(mms.build_baseline_graph(), mms.init_params("baseline_net", 0),
               device="cpu")
    rng = np.random.default_rng(2)
    e.calibrate([mms.synthetic_input(rng) for _ in range(2)])
    batch = mms.synthetic_batch(rng, 4)
    e.run_batch(batch, "accel")             # lowered before profiling

    def profiled():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = e.run_batch(batch, "accel")
        seen = sorted((ev.time_range.start, ev.name) for ev in prof.events()
                      if ev.name in ("plan.flex", "plan.accel"))
        return out, [name for _, name in seen]

    off, off_names = profiled()
    spans.enable("cpu")
    on, on_names = profiled()
    spans.disable()
    segments = e.planned("accel").segments
    assert {s.backend for s in segments} == {"flex", "accel"}
    assert off_names == []
    assert on_names == [s.span for s in segments]
    for k in off:
        assert torch.equal(torch.as_tensor(on[k]), torch.as_tensor(off[k]))


def test_card_clock_maps_between_anchors():
    """A card's event time maps to the host's clock along the anchors
    around it, and past the last one by that anchor's offset."""
    clock = spans._Clock.__new__(spans._Clock)
    clock.dev = [0.0, 1e9, 2e9]
    clock.hosts = [500, 500 + 10**9 + 4_000, 500 + 2 * 10**9 + 14_000]
    assert clock.host(0.0) == 500
    assert clock.host(0.5e9) == 500 + 500_000_000 + 2_000
    assert clock.host(1.5e9) == 500 + 1_500_000_000 + 9_000
    assert clock.host(3e9) == 500 + 3 * 10**9 + 14_000


class _FakeEvent:
    """A card's timing event whose ``query`` turns true at its
    ``done_at``-th call; every event lies 2 ms after the first."""
    done_at = 3

    def __init__(self, enable_timing=False):
        self.queries = 0

    def record(self, stream=None):
        pass

    def query(self):
        self.queries += 1
        return self.queries >= self.done_at

    def elapsed_time(self, other):
        return 2.0


def test_card_clock_polls_an_anchor_while_idle(monkeypatch):
    """An idle poll anchors the event at the middle of its narrowest
    bracket (the last query that missed it, the one that saw it), then
    waits a second; a card busy past ``POLL_NS`` gives no anchor and a
    retry after ``RETRY_NS``."""
    ticks = iter(range(1000, 10**7, 100))
    monkeypatch.setattr(spans.time, "monotonic_ns", lambda: next(ticks))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    clock = spans._Clock.__new__(spans._Clock)
    clock.device, clock.ref = "cuda", _FakeEvent()
    clock.dev, clock.hosts, clock.next_poll = [0.0], [0], 0
    clock.poll()
    # now 1000, issued after 1100; queries at 1200-1300 and 1400-1500
    # miss it, 1600-1700 sees it
    assert clock.dev == [0.0, 2e6] and clock.hosts == [0, 1550]
    assert clock.next_poll == 1700 + clock.EVERY_NS
    clock.poll()                        # 1800, within the second
    assert len(clock.dev) == 2
    monkeypatch.setattr(_FakeEvent, "done_at", 10**9)
    clock.next_poll = 0
    clock.poll()                        # from 1900, never seen
    assert len(clock.dev) == 2
    assert clock.next_poll == 1900 + clock.RETRY_NS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    return torch.device("cuda")


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")()
                                              * 1000)


def done_against_profiler(prof_events, recs, offset_ns):
    """For each record, ``done`` moved to the profiler's clock minus the end
    of the last device operation that its plan call launched (the runtime
    calls between ``stage1`` and ``launched``, which bracket the
    ``plan.dispatch`` span), in ns; None where there is none."""
    launch_at, ends = {}, []
    for e in prof_events:
        start = _ns(e, "start")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ends.append((e.correlation_id(), start + _ns(e, "duration")))
        elif e.name().startswith("cu"):
            launch_at[e.correlation_id()] = start
    launched = sorted((launch_at[c], end) for c, end in ends
                      if c in launch_at)
    at = [a for a, _ in launched]
    gaps = []
    for r in recs:
        lo = bisect.bisect_left(at, r.stage1 + offset_ns)
        hi = bisect.bisect_right(at, r.launched + offset_ns)
        mine = [end for _, end in launched[lo:hi]]
        gaps.append(r.done + offset_ns - max(mine) if mine else None)
    return gaps


def profiler_offset(events, marks, guess):
    """The profiler's clock minus the host's monotonic one, from runtime
    calls (``cudaStreamQuery``) bracketed by host reads: the median over
    marks of the nearest such call's start minus the bracket's middle
    (``guess`` places the brackets; the profiler converts its own clock to
    wall time, off by up to hundreds of us from ``time.time_ns``)."""
    q = sorted(_ns(e, "start") for e in events
               if e.name() == "cudaStreamQuery")
    diffs = []
    for h0, h1 in marks:
        mid = (h0 + h1) // 2 + guess
        k = bisect.bisect_left(q, mid)
        near = [x for x in q[max(k - 1, 0):k + 1] if abs(x - mid) < 10**6]
        if near:
            diffs.append(min(near, key=lambda x: abs(x - mid)) - mid + guess)
    assert len(diffs) >= len(marks) // 2, (len(diffs), len(marks))
    return int(np.median(diffs))


@pytest.mark.gpu
def test_done_agrees_with_the_profiler(card):
    """Full-width CNet served by the threaded dispatcher on the card,
    bursts of 16 frames and single frames, so that the card is idle or
    busy when a plan ends. Over a profiled stretch 10 s after tracing was
    turned on (the card's timer drifts from the host's meanwhile), each
    record's ``done``, moved to the profiler's clock by the stored offset,
    lies within 0.1 ms of the end of the last device operation its plan
    call launched, for at least 95% of dispatches. The same placed by the
    profiler's own offset from the host's clock (read from marked runtime
    calls, tens of us from the stored one) is printed beside it."""
    g = tcnet.build_graph()
    e = Engine(g, tcnet.init_params(3), device=card)
    shape = g.graph_inputs["image"]
    e.calibrate(_requests(4, seed=3, shape=shape))
    s = ContinuousBatchingScheduler(pipeline=True)
    s.register(MODEL, e, backend="accel", ladder=(1, 16), deadline_s=0.02,
               warmup_sample=_requests(1, seed=1, shape=shape)[0])
    frames = _requests(16, seed=7, shape=shape)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):   # the tracer's start-up
        torch.zeros(1, device=card).add_(1)
    prof = torch.profiler.profile(activities=acts)
    spans.enable(card)
    s.start()
    t0, i, start, marks = time.monotonic_ns(), 0, None, []
    while start is None or time.monotonic_ns() - start < 2 * 10**9:
        if start is None and time.monotonic_ns() - t0 > 10 * 10**9:
            prof.start()
            start = time.monotonic_ns()
        if start is not None:
            h0 = time.monotonic_ns()
            torch.cuda.current_stream(card).query()
            marks.append((h0, time.monotonic_ns()))
        for f in frames[:16 if i % 3 else 1]:
            s.submit(MODEL, f)
        time.sleep((0.004, 0.006, 0.01)[i % 3])
        i += 1
    prof.stop()
    window = (start, time.monotonic_ns())
    s.stop()
    spans.disable()
    recs = [r for r in spans.records()
            if window[0] <= r.stage1 and r.launched <= window[1]]
    assert len(recs) >= 100
    events = prof.profiler.kineto_results.events()
    offset = profiler_offset(events, marks, spans.offset_ns())
    report = []
    for name, off in (("stored offset", spans.offset_ns()),
                      ("profiler's offset", offset)):
        gaps = done_against_profiler(events, recs, off)
        found = [abs(x) for x in gaps if x is not None]
        within = sum(x <= 100_000 for x in found)
        report.append(within)
        print(f"done vs profiler by the {name}: {len(found)} of {len(gaps)} "
              f"matched, {within} within 0.1 ms, median "
              f"{np.median(found) / 1e3:.2f} us, worst "
              f"{max(found) / 1e3:.2f} us")
    launch_at = {e.correlation_id(): _ns(e, "start") for e in events
                  if e.device_type() != torch.autograd.DeviceType.CUDA
                  and e.name().startswith("cu")}
    lag = [_ns(e, "start") - launch_at[e.correlation_id()] for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.correlation_id() in launch_at]
    print(f"profiler's offset minus the stored one: "
          f"{(offset - spans.offset_ns()) / 1e3:.2f} us; device start minus "
          f"its launch call: min {min(lag) / 1e3:.2f} median "
          f"{np.median(lag) / 1e3:.2f} us; {torch.cuda.get_device_name(0)}")
    assert report[0] >= 0.95 * len(recs)


@pytest.mark.gpu
def test_single_frames_retire_when_the_card_finishes(card):
    """Full-width CNet served one frame a dispatch by the threaded
    dispatcher, with idle gaps between frames: each dispatch retires once
    the card has finished it, not when a later one needs its slot, so the
    median of ``retire0 - done`` is under 1 ms."""
    g = tcnet.build_graph()
    e = Engine(g, tcnet.init_params(3), device=card)
    shape = g.graph_inputs["image"]
    e.calibrate(_requests(4, seed=3, shape=shape))
    s = ContinuousBatchingScheduler(pipeline=True)
    s.register(MODEL, e, backend="accel", ladder=(1,), deadline_s=2.0,
               warmup_sample=_requests(1, seed=1, shape=shape)[0])
    frames = _requests(8, seed=11, shape=shape)
    n = 200
    spans.enable(card)
    s.start()
    for i in range(n):
        s.submit(MODEL, frames[i % len(frames)])
        time.sleep(0.005)
    t_end = time.monotonic() + 10
    while len(s.completions) < n and time.monotonic() < t_end:
        time.sleep(0.005)
    answered = len(s.completions)
    s.stop()
    spans.disable()
    recs = spans.records()
    lag = np.array([r.retire0 - r.done for r in recs]) / 1e6
    causes = {c: sum(r.cause == c for r in recs) for c in ("done", "slot",
                                                           "sync")}
    print(f"retire0 - done: median {np.median(lag):.3f} ms, p95 "
          f"{np.percentile(lag, 95):.3f} ms over {len(recs)} dispatches; "
          f"causes {causes}; {torch.cuda.get_device_name(0)}")
    assert answered == n and len(recs) == n
    assert np.median(lag) < 1.0
    assert causes["done"] >= 0.9 * n
