"""The port's serving layer: staging, the pipeline, and the
continuous-batching scheduler, held against the JAX reference.

Under ``clock="modeled"`` a dispatch occupies its plan's modeled latency,
so the same arrival trace must give dispatch records identical to the
reference scheduler's, one for one, and (on the int8 accel path, with the
calibration carried over) bit-identical outputs per request.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import dataclasses
import time

import numpy as np
import torch

from repro.core.scheduler import ContinuousBatchingScheduler as JSched
from repro.core.scheduler import bursty_arrivals as j_bursty
from repro.core.scheduler import capped_ladder as j_capped
from repro.core.scheduler import poisson_arrivals as j_poisson
from repro_torch.core.energy import PowerEnvelope
from repro_torch.core.pipeline import (ServingPipeline, split_seeds,
                                       stage_batch)
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        bursty_arrivals, capped_ladder,
                                        poisson_arrivals)
from repro_torch.models import cnet_plus_scalar as tcnet
from test_torch_support import NARROW, twin_engines

LADDER = (1, 4)


@pytest.fixture(scope="module")
def engines():
    je, te, _ = twin_engines(carry=True)
    return je, te


def _requests(n, seed=11):
    rng = np.random.default_rng(seed)
    return [tcnet.synthetic_input(rng, NARROW["input_shape"])
            for _ in range(n)]


def test_modeled_serve_trace_matches_reference(engines):
    je, te = engines
    reqs = _requests(11)
    times = poisson_arrivals(900.0, len(reqs), seed=3)
    trace = [(t, "cnet_plus_scalar", r) for t, r in zip(times, reqs)]
    scheds = []
    for cls, eng in ((JSched, je), (ContinuousBatchingScheduler, te)):
        s = cls(clock="modeled", pipeline=True)
        s.register("cnet_plus_scalar", eng, backend="accel", ladder=LADDER,
                   deadline_s=0.004)
        end = s.serve_trace(trace)
        scheds.append((s, end))
    (js, jend), (ts, tend) = scheds
    assert tend == jend
    assert len(ts.dispatches) == len(js.dispatches) > 2
    for t, j in zip(ts.dispatches, js.dispatches):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert {r for r in (d.mode for d in ts.dispatches)} == {"full", "flush"}
    assert ts.overlap_report() == js.overlap_report()
    jc = {c.rid: c for c in js.completions}
    assert sorted(c.rid for c in ts.completions) == sorted(jc)
    for c in ts.completions:
        j = jc[c.rid]
        assert (c.finished, c.rung, c.n_real, c.kept) == (
            j.finished, j.rung, j.n_real, j.kept)
        np.testing.assert_array_equal(c.outputs["head"],
                                      np.asarray(j.outputs["head"]))
    tt, jt = ts.telemetry()["cnet_plus_scalar"], js.telemetry()[
        "cnet_plus_scalar"]
    assert tt.to_dict() == jt.to_dict()


def test_pipelined_equals_synchronous_dispatch(engines):
    _, te = engines
    reqs = _requests(9, seed=5)
    trace = [(t, "cnet_plus_scalar", r) for t, r in
             zip(bursty_arrivals(len(reqs), 4, 0.01), reqs)]
    runs = []
    for pipeline in (False, True):
        s = ContinuousBatchingScheduler(clock="modeled", pipeline=pipeline)
        s.register("cnet_plus_scalar", te, backend="accel", ladder=LADDER)
        s.serve_trace(trace)
        runs.append(s)
    a, b = runs
    assert [dataclasses.asdict(d) for d in a.dispatches] == [
        dataclasses.asdict(d) for d in b.dispatches]
    for ca, cb in zip(sorted(a.completions, key=lambda c: c.rid),
                      sorted(b.completions, key=lambda c: c.rid)):
        assert np.array_equal(ca.outputs["head"], cb.outputs["head"])


def test_stage_batch_and_arena_slots_are_bit_identical(engines):
    _, te = engines
    pipe = ServingPipeline(te, "accel", batch_size=4, staging_buffers=2)
    reqs = _requests(4, seed=2)
    for n in (4, 1, 3, 2):            # shrinking ragged batches reuse slots
        slot = pipe.arena.acquire()
        host = pipe.arena.stage(slot, reqs[:n])
        fresh = stage_batch(reqs[:n], 4, torch.device("cpu"))
        for k in fresh:
            assert torch.equal(host[k], fresh[k])
        pipe.arena.release(slot)
    assert pipe.arena.n_staged == 4
    with pytest.raises(ValueError):
        stage_batch([], 4, torch.device("cpu"))
    with pytest.raises(ValueError):
        stage_batch(reqs, 2, torch.device("cpu"))


def test_pipeline_ragged_tail_and_empty_stream(engines):
    _, te = engines
    pipe = ServingPipeline(te, "accel", batch_size=4)
    reqs = _requests(6, seed=4)
    padded = stage_batch(reqs[4:], 4, torch.device("cpu"))
    want = te.compile("accel", 4)(padded, torch.zeros((4, 2),
                                                      dtype=torch.int64))
    res = pipe.execute_batch(reqs[4:])
    np.testing.assert_array_equal(res.outputs["head"],
                                  want["head"][:2].numpy())
    assert pipe.run([]).n_requests == 0
    tickets = [pipe.execute_batch_async(reqs[:4]) for _ in range(2)]
    pipe.sync()
    assert all(t.retired for t in tickets) and pipe.arena.n_free == 2
    for pipeline in (True, False):
        st = pipe.run(reqs, pipeline=pipeline)
        assert st.n_requests == 6 and pipe.arena.n_free == 2
    assert pipe.arena.n_fallback == 0


def test_failed_retirement_releases_the_slot(engines):
    _, te = engines

    def boom(out):
        raise RuntimeError("predicate failed")
    pipe = ServingPipeline(te, "accel", batch_size=1, keep_predicate=boom)
    ticket = pipe.execute_batch_async(_requests(1))
    with pytest.raises(RuntimeError, match="predicate"):
        ticket.retire()
    assert pipe.arena.n_free == pipe.arena.n_slots
    with pytest.raises(RuntimeError, match="abandoned"):
        ticket.retire()


def test_async_wall_clock_mode_serves_everything(engines):
    _, te = engines
    s = ContinuousBatchingScheduler(pipeline=True)
    s.register("cnet_plus_scalar", te, backend=("accel", "flex"),
               ladder=LADDER, deadline_s=0.05, warmup_sample=_requests(1)[0])
    s.start(poll_s=0.0005)
    for r in _requests(7, seed=9):
        s.submit("cnet_plus_scalar", r)
        time.sleep(0.001)
    s.stop()
    tel = s.telemetry()["cnet_plus_scalar"]
    assert tel.n_completed == tel.n_submitted == 7
    assert sorted(c.rid for c in s.completions) == list(range(7))
    assert all(d.rung in LADDER for d in s.dispatches)


def test_envelope_falls_back_and_never_drops(engines):
    """A peak cap below the accel analog's modeled power moves dispatch to
    the flex fallback; every request is still served exactly once."""
    _, te = engines
    probe = ContinuousBatchingScheduler(clock="modeled")
    probe.register("cnet_plus_scalar", te, backend=("accel", "flex"),
                   ladder=LADDER)
    costs = probe._svcs["cnet_plus_scalar"].costs
    cap = 0.5 * (costs[("accel", 1)].power_w + costs[("flex", 1)].power_w)
    lo, hi = sorted((costs[("accel", 1)].power_w,
                     costs[("flex", 1)].power_w))
    s = ContinuousBatchingScheduler(
        clock="modeled", envelope=PowerEnvelope(sustained_w=float("inf"),
                                                peak_w=cap))
    s.register("cnet_plus_scalar", te, backend=("accel", "flex"),
               ladder=LADDER)
    reqs = _requests(6, seed=1)
    s.serve_trace([(0.001 * i, "cnet_plus_scalar", r)
                   for i, r in enumerate(reqs)])
    assert sorted(c.rid for c in s.completions) == list(range(6))
    used = {d.backend for d in s.dispatches}
    assert len(used) == 1 and lo < cap < hi
    assert s.envelope_report()["n_violations"] == 0


def test_trace_helpers_match_reference():
    assert poisson_arrivals(40.0, 20, seed=4) == j_poisson(40.0, 20, seed=4)
    assert (bursty_arrivals(10, 3, 0.2, 0.01, seed=1)
            == j_bursty(10, 3, 0.2, 0.01, seed=1))
    for top in (1, 3, 16, 64):
        assert capped_ladder(top) == j_capped(top)
    with pytest.raises(ValueError):
        capped_ladder(0)


def test_seed_chain_is_deterministic():
    s = np.array([7, 0], np.uint32)
    a, b = split_seeds(s, 5), split_seeds(s, 5)
    assert a.shape == (5, 2) and a.dtype == np.uint32
    assert np.array_equal(a, b) and len({tuple(r) for r in a}) == 5


# -- retirement on completion (the threaded, pipelined dispatcher) ----------

MODEL = "cnet_plus_scalar"


class _Held:
    """A dispatch ticket whose device work counts as finished only once
    ``ready`` is set (or the dispatcher has waited on it)."""

    def __init__(self, ticket):
        self.ticket, self.ready, self.waits = ticket, False, 0

    def done(self):
        return self.ready

    def wait(self):
        self.waits += 1
        self.ready = True

    def retire(self):
        return self.ticket.retire()


def _pipelined(te, staging_buffers=2, ladder=(1,)):
    s = ContinuousBatchingScheduler(pipeline=True,
                                    staging_buffers=staging_buffers)
    s.register(MODEL, te, backend="accel", ladder=ladder, deadline_s=0.05,
               warmup_sample=_requests(1)[0])
    return s


def _dispatch_held(s, req):
    """Submit one request, dispatch it at rung 1 and hold its ticket."""
    s.submit(MODEL, req)
    assert s.step(time.monotonic()) is not None
    inf = s._inflight[-1]
    inf.ticket = _Held(inf.ticket)
    return inf.ticket


@pytest.mark.parametrize("staging_buffers", [1, 2])
def test_lone_request_is_answered_while_the_dispatcher_idles(
        engines, staging_buffers):
    """One request and nothing after it: no later dispatch, ``sync()``,
    ``telemetry()`` or ``stop()`` retires it, so the dispatcher must retire
    it once its device work has finished."""
    _, te = engines
    s = _pipelined(te, staging_buffers, ladder=LADDER)
    s.start(poll_s=0.0005)
    try:
        s.submit(MODEL, _requests(1, seed=6)[0])
        t_end = time.monotonic() + 1.0
        while not s.completions and time.monotonic() < t_end:
            time.sleep(0.002)
        assert [c.rid for c in s.completions] == [0]
        assert s.retire_causes["done"] >= 1
    finally:
        s.stop()
    assert s.retire_causes["slot"] == 0
    assert "[pipeline] retired done=1 slot=0 sync=0" in s.summary()


def test_idle_dispatcher_waits_on_the_oldest_dispatch_not_the_poll(engines):
    """With nothing to dispatch and a dispatch in flight, one pass of the
    loop waits for that dispatch's device work and retires it, without
    sleeping its poll interval first."""
    _, te = engines
    s = _pipelined(te)
    held = _dispatch_held(s, _requests(1, seed=7)[0])
    t0 = time.monotonic()
    s._serve_once(poll_s=5.0)
    assert time.monotonic() - t0 < 2.5
    assert held.waits == 1 and [c.rid for c in s.completions] == [0]
    assert s.retire_causes == {"done": 1, "slot": 0, "sync": 0}


def test_finished_dispatches_retire_in_dispatch_order(engines):
    """A finished dispatch behind an unfinished one waits for it, then
    both retire, oldest first."""
    _, te = engines
    s = _pipelined(te, staging_buffers=3)
    held = [_dispatch_held(s, r) for r in _requests(2, seed=8)]
    held[1].ready = True
    s._retire_finished()
    assert s.completions == [] and len(s._inflight) == 2
    held[0].ready = True
    s._retire_finished()
    assert [c.rid for c in s.completions] == [0, 1] and not s._inflight
    assert s.retire_causes == {"done": 2, "slot": 0, "sync": 0}


def test_slot_pressure_retires_what_the_card_has_not_finished(engines):
    """Dispatches whose device work never reads finished still retire when
    a later dispatch needs their staging slot, so no dispatch stages into a
    fresh allocation; the last two retire at the sync."""
    _, te = engines
    s = _pipelined(te, staging_buffers=2)
    for r in _requests(5, seed=12):
        _dispatch_held(s, r)
        s._retire_finished()
    assert len(s._inflight) == 2
    assert s.retire_causes == {"done": 0, "slot": 3, "sync": 0}
    s.sync()
    assert s.retire_causes == {"done": 0, "slot": 3, "sync": 2}
    assert [c.rid for c in s.completions] == list(range(5))
    pipes = s._svcs[MODEL].pipelines["accel"].values()
    assert sum(p.arena.n_fallback for p in pipes) == 0
    assert all(p.arena.n_free == p.arena.n_slots for p in pipes)
