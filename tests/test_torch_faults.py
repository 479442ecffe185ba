"""The port's degraded-mode stack (``core/faults.py`` and the scheduler's
fault hooks and ledger) held against the JAX reference's, on the
reference fault tests' engines: ``multi_esperta`` (four int8 dense heads
on this calibration) and ``logistic_net``, params and the 2-sample
calibration drawn on the JAX side and carried over as numpy, served on
``("accel", "cpu")`` over the ladder (1, 4) under the modeled clock. The
reference's Pallas kernels run in interpret mode, as its own tests run
them on the CPU.

Held exactly: the injector's draws and the bytes it flips, every storm's
event ledger and ``report()`` (the modeled clock makes both
deterministic), dispatch records, the drift report, and
``logistic_net``'s canary digest (its int8 chain is bit-exact). A
corrupted ``multi_esperta`` output is held to the reference's within
1e-6 relative (its sigmoid), as ``tests/test_torch_space_models.py``
holds the pristine one.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import dataclasses

import jax
import numpy as np
import torch

from repro.core import faults as jfaults
from repro.core.pipeline import ServingPipeline as JPipeline
from repro.models import synthetic_requests
from repro_torch.core import energy, faults
from repro_torch.core.pipeline import ServingPipeline
from repro_torch.core.radiation import UpsetEvent
from repro_torch.core.scheduler import ContinuousBatchingScheduler
from test_torch_support import fault_twins, storm

MODEL = "multi_esperta"             # int8 dense heads -> real arenas
CO_MODEL = "logistic_net"
N = 24
PERIOD = 0.05


@pytest.fixture(scope="module")
def engines():
    return fault_twins((MODEL, CO_MODEL))


@pytest.fixture(autouse=True)
def pristine(engines):
    """Every test leaves both packages' shared accel arenas pristine (a
    canary cannot see a flip its input never reaches)."""
    yield
    for _, je, te in engines.values():
        je.planned("accel").repack_weights()
        te.planned("accel").repack_weights()


@pytest.fixture()
def plans(engines):
    """The shared accel plans of both packages."""
    _, je, te = engines[MODEL]
    return je.planned("accel"), te.planned("accel")


def _arena_bytes(plan):
    return {n: np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            .view(np.uint8).reshape(-1).copy()
            for n, a in plan.weight_arena.items()}


def _events(ctl):
    return [dataclasses.asdict(e) for e in ctl.events]


def _meta(sched):
    return [(c.rid, c.model, c.kept, c.arrival, c.finished, c.rung,
             c.n_real) for c in sched.completions]


# ---------------------------------------------------------------------------
# injector + arena repack
# ---------------------------------------------------------------------------


def test_arenas_match_the_reference(plans):
    jp, tp = plans
    j, t = _arena_bytes(jp), _arena_bytes(tp)
    assert sorted(j) == sorted(t) and j
    for n in j:
        assert np.array_equal(j[n], t[n]), n


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
def test_injector_draws_and_flips_match_the_reference(plans, seed):
    """The same seed draws the same (node, byte, bit) on the same arena
    and leaves the same flipped bytes, the entry replaced by a fresh
    tensor on the plan's device."""
    jp, tp = plans
    old = dict(tp.weight_arena)
    got = faults.SEUInjector(seed).flip(tp)
    assert got == jfaults.SEUInjector(seed).flip(jp)
    assert tp.weight_arena[got[0]] is not old[got[0]]
    assert tp.weight_arena[got[0]].device == tp.device
    j, t = _arena_bytes(jp), _arena_bytes(tp)
    assert all(np.array_equal(j[n], t[n]) for n in j)


@pytest.mark.parametrize("name", [MODEL, CO_MODEL])
def test_prepacked_arena_weighting_matches_the_reference(name):
    """Under the autotuner the arena holds the tile-padded packed buffers
    (a flip in padding is invisible to any canary, in both packages
    alike): the port weights its draws by the same padded bytes, so the
    same seeds flip the same bytes."""
    engines = fault_twins((name,), autotune=True)
    _, je, te = engines[name]
    je.compile("accel", 4)
    te.compile("accel", 4)
    jp, tp = je.planned("accel"), te.planned("accel")
    assert tp.packed and {n: tuple(a.shape) for n, a in
                          tp.weight_arena.items()} == \
        {n: tuple(a.shape) for n, a in jp.weight_arena.items()}
    for seed in range(5):
        assert faults.SEUInjector(seed).flip(tp) == \
            jfaults.SEUInjector(seed).flip(jp)
    j, t = _arena_bytes(jp), _arena_bytes(tp)
    assert all(np.array_equal(j[n], t[n]) for n in j)


def test_injector_deterministic_per_seed(plans):
    _, tp = plans
    a = faults.SEUInjector(seed=7).flip(tp)
    tp.repack_weights()
    b = faults.SEUInjector(seed=7).flip(tp)
    tp.repack_weights()
    c = faults.SEUInjector(seed=8).flip(tp)
    assert a == b and a != c


def test_flip_corrupts_lowered_output_without_relowering(engines, plans):
    """A bit flip in the live arena changes what the already-lowered
    plan computes, with no re-lowering, as the reference's flip changes
    its compiled plan's output; repacking restores it bit-exact."""
    m, je, te = engines[MODEL]
    jp, tp = plans
    inputs = {k: np.asarray(v) for k, v in
              m.synthetic_batch(jax.random.PRNGKey(11), 2).items()}
    rngs = np.asarray(jax.random.split(jax.random.PRNGKey(7), 2))
    before = {k: v.numpy() for k, v in
              te.run_batch(inputs, "accel", rngs).items()}
    n_traces = tp.n_traces
    node, byte, bit = faults.SEUInjector(seed=0).flip(tp)
    assert jfaults.SEUInjector(seed=0).flip(jp) == (node, byte, bit)
    corrupt = {k: v.numpy() for k, v in
               te.run_batch(inputs, "accel", rngs).items()}
    want = je.run_batch(inputs, "accel", rngs)
    assert tp.n_traces == n_traces
    assert any(not np.array_equal(corrupt[k], before[k]) for k in before), (
        f"flip of {node}[{byte}]:{bit} did not reach the plan")
    for k in before:
        if k.startswith("prob"):
            np.testing.assert_allclose(corrupt[k], np.asarray(want[k]),
                                       rtol=1e-6, atol=0)
    assert tp.repack_weights() == jp.repack_weights() > 0
    after = te.run_batch(inputs, "accel", rngs)
    assert tp.n_traces == n_traces
    for k in before:
        np.testing.assert_array_equal(after[k].numpy(), before[k])
    for name, a in tp.weight_arena.items():
        np.testing.assert_array_equal(a.numpy(), tp.host_weights[name])


def test_flip_pinned_target(plans):
    _, tp = plans
    node = max(tp.weight_arena, key=lambda n: tp.host_weights[n].nbytes)
    got = faults.SEUInjector(seed=0).flip(tp, node=node, byte=1, bit=5)
    assert got == (node, 1, 5)
    diff = (tp.host_weights[node].view(np.uint8).reshape(-1)
            ^ tp.weight_arena[node].numpy().view(np.uint8).reshape(-1))
    assert diff[1] == (1 << 5) and int(diff.sum()) == (1 << 5)


def test_injector_rejects_empty_arena(engines):
    _, _, te = engines[MODEL]
    plan = te.planned("flex")       # fp32 plans carry no quantized arena
    assert plan.weight_arena == {}
    with pytest.raises(ValueError, match="no quantized weight arena"):
        faults.SEUInjector(seed=0).flip(plan)


def test_staging_flip_is_transient_and_matches_the_reference(engines):
    """The flip goes through the staging tensor's numpy view (the same
    draw as the reference's flip of its numpy buffer) and the next
    ``stage()`` rewrites it."""
    m, je, te = engines[MODEL]
    reqs = synthetic_requests(m, 4, seed=3)
    jpipe = JPipeline(je, backend="accel", batch_size=4)
    pipe = ServingPipeline(te, backend="accel", batch_size=4)
    jpipe.execute_batch(reqs, rng=jax.random.PRNGKey(0))
    ref = pipe.execute_batch(reqs, rng=np.zeros(2, np.uint32))
    staged = {k: v.numpy().copy() for k, v in pipe.arena._bufs[0].items()}
    got = faults.SEUInjector(seed=0).flip_staging(pipe.arena, slot=0)
    assert got == jfaults.SEUInjector(seed=0).flip_staging(jpipe.arena,
                                                           slot=0)
    name, byte, bit = got
    flat = pipe.arena._bufs[0][name].numpy().view(np.uint8).reshape(-1)
    assert flat[byte] == staged[name].view(np.uint8).reshape(-1)[byte] \
        ^ (1 << bit)
    again = pipe.execute_batch(reqs, rng=np.zeros(2, np.uint32))
    for k in ref.outputs:           # stage() rewrote every row
        np.testing.assert_array_equal(again.outputs[k], ref.outputs[k])


# ---------------------------------------------------------------------------
# canaries
# ---------------------------------------------------------------------------


def test_output_digest_sensitive_stable_and_the_references():
    out = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": np.array([1, 3], np.int32)}
    d1 = faults.output_digest(out)
    assert d1 == jfaults.output_digest(out)
    perturbed = {"a": out["a"].copy(), "b": out["b"]}
    perturbed["a"][1, 2] += 0.5
    assert faults.output_digest(perturbed) != d1
    assert faults.output_digest({"c": out["a"], "b": out["b"]}) != d1


def test_canary_digest_matches_the_reference(engines):
    """logistic_net's int8 chain is bit-exact, so the port's pristine
    canary (the PRNGKey(20260801) key data as its seed) pins the
    reference's digest."""
    _, jctl, _ = storm("jax", engines, (CO_MODEL,), 2, serve=False)
    _, tctl, _ = storm("torch", engines, (CO_MODEL,), 2, serve=False)
    j, t = jctl._models[CO_MODEL].canary, tctl._models[CO_MODEL].canary
    assert t.digest == j.digest
    assert {k: (v.dtype, v.shape) for k, v in t.reference.items()} == \
        {k: (v.dtype, v.shape) for k, v in j.reference.items()}
    assert faults._CANARY_SEED.tolist() == \
        np.asarray(jax.random.PRNGKey(jfaults._CANARY_KEY)).tolist()


def test_canary_detects_flip_and_recovery(engines, plans):
    _, tp = plans
    _, ctl, _ = storm("torch", engines, (MODEL,), N, serve=False, seed=0)
    canary = ctl._models[MODEL].canary
    assert canary.check()[0]
    ctl.injector.flip(tp)
    ok, got = canary.check()
    assert not ok and got != canary.digest
    tp.repack_weights()
    assert canary.check()[0]


# ---------------------------------------------------------------------------
# the controller under the modeled clock, against the reference
# ---------------------------------------------------------------------------


STORMS = {
    "repack": dict(seed=0, fault_times=(0.012,), self_test_period=PERIOD,
                   recovery="repack"),
    "demote": dict(seed=0, fault_times=(0.005,), self_test_period=0.02,
                   recovery="demote", repair_delay_s=0.03),
    "poisson-two-models": dict(seed=1, fault_rate=100.0, horizon_s=0.08,
                               self_test_period=0.02, names=(MODEL,
                                                             CO_MODEL)),
}


@pytest.mark.parametrize("case", sorted(STORMS))
def test_storm_ledger_matches_the_reference(engines, case):
    cfg = dict(STORMS[case])
    names = cfg.pop("names", (MODEL,))
    js, jc, _ = storm("jax", engines, names, N, **cfg)
    ts, tc, _ = storm("torch", engines, names, N, **cfg)
    rep = tc.report()
    assert rep == jc.report()
    assert rep["n_injected"] >= 1
    assert rep["n_recovered"] == rep["n_detected"] >= 1
    assert [dataclasses.asdict(d) for d in ts.dispatches] == \
        [dataclasses.asdict(d) for d in js.dispatches]
    assert _meta(ts) == _meta(js)
    assert sorted(c.rid for c in ts.completions) == \
        list(range(N * len(names)))
    assert tc.drift_report(ts) == jc.drift_report(js)
    assert not any(ts._svcs[name].quarantined for name in names)
    if case == "demote":
        assert rep["events"][0]["action"] == "demote+repack"
        assert any(d.backend == "cpu" for d in ts.dispatches)
    if case == "repack":
        (ev,) = rep["events"]
        bound = PERIOD * (1 + tc.config.aging_fraction) + 0.01
        assert ev["detected_at"] - ev["t_injected"] <= bound
        assert ev["action"] == "repack"


def test_demote_requires_fallback_backend(engines):
    m, _, _ = engines[MODEL]
    reqs = synthetic_requests(m, 2, seed=5)
    sched, ctl, _ = storm("torch", engines, (MODEL,), 2, serve=False,
                          backends="accel", ladder=(1,), seed=0,
                          fault_times=(0.0,), self_test_period=0.001,
                          recovery="demote")
    with pytest.raises(RuntimeError, match="fallback backend"):
        sched.serve_trace([(0.0, MODEL, reqs[0])])
    ctl._models[MODEL].plan.repack_weights()


def test_inert_controller_is_bit_identical_to_no_controller(engines):
    names = (MODEL, CO_MODEL)
    plain = ContinuousBatchingScheduler(clock="modeled")
    armed, ctl, trace = storm("torch", engines, names, N, serve=False)
    for mi, name in enumerate(names):
        m, _, te = engines[name]
        plain.register(name, te, backend=("accel", "cpu"), ladder=(1, 4),
                       warmup_sample=synthetic_requests(m, 1,
                                                        seed=5 + mi)[0])
    plain.serve_trace(trace)
    armed.serve_trace(trace)
    assert ctl.report()["n_self_tests"] == 0
    assert armed.dispatches == plain.dispatches
    assert _meta(armed) == _meta(plain)
    for a, b in zip(armed.completions, plain.completions):
        for k in b.outputs:
            np.testing.assert_array_equal(a.outputs[k], b.outputs[k])


def test_fault_config_validation_and_schedule():
    with pytest.raises(ValueError, match="repack|demote"):
        faults.FaultConfig(recovery="reboot")
    with pytest.raises(ValueError, match="protection"):
        faults.FaultConfig(protection="parity")
    assert faults.FaultConfig().schedule() == []
    cfg = faults.FaultConfig(seed=3, fault_rate=100.0, horizon_s=0.5)
    times = cfg.schedule()
    assert times == cfg.schedule() == jfaults.FaultConfig(
        seed=3, fault_rate=100.0, horizon_s=0.5).schedule()
    assert times == sorted(times) and all(0 < t < 0.5 for t in times)
    assert faults.FaultConfig(fault_times=(0.3, 0.1)).schedule() == \
        [0.1, 0.3]


def test_half_specified_poisson_storm_names_missing_field():
    with pytest.raises(ValueError, match="horizon_s"):
        faults.FaultConfig(fault_rate=5.0)
    with pytest.raises(ValueError, match="fault_rate"):
        faults.FaultConfig(horizon_s=1.0)
    assert faults.FaultConfig().upset_schedule() == []
    assert faults.FaultConfig(fault_times=(0.1,), horizon_s=1.0)
    cfg = faults.FaultConfig(upsets=(UpsetEvent(0.2), UpsetEvent(0.1)))
    assert [ev.t for ev in cfg.upset_schedule()] == [0.1, 0.2]


def test_repack_cost_pricing():
    hw = energy.BACKEND_HW["accel"]
    small = energy.repack_cost(hw, 1024)
    big = energy.repack_cost(hw, 1 << 20)
    assert 0 < small.seconds < big.seconds
    assert 0 < small.energy_j < big.energy_j
    assert small.seconds == pytest.approx(
        hw.overhead_s + 1024 / (hw.stage_bw or hw.hbm_bw))


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------


def _walk_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_walk_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_walk_equal(x, y) for x, y in zip(a, b)))
    return a == b


def test_checkpoint_file_roundtrip_and_format(tmp_path):
    state = {"version": 1, "pi": 3.5, "name": "sched", "flag": True,
             "nested": {"arr": np.arange(5, dtype=np.int8),
                        "list": [np.ones((2, 2), np.float32), "x", None]},
             "empty": {}}
    path = str(tmp_path / "ck.npz")
    faults.save_checkpoint(path, state)
    assert _walk_equal(faults.load_checkpoint(path), state)
    assert _walk_equal(jfaults.load_checkpoint(path), state)
    with np.load(path, allow_pickle=False) as data:
        assert "__meta__" in data
    with pytest.raises(TypeError, match="Tensor"):
        faults.save_checkpoint(str(tmp_path / "t.npz"),
                               {"w": torch.zeros(2)})


def test_scheduler_state_dict_roundtrip(engines, tmp_path):
    names = (MODEL, CO_MODEL)
    sched, _, trace = storm("torch", engines, names, N, serve=False)
    sched.serve_trace(trace, stop_at=0.02)
    state = sched.state_dict()
    assert state["models"][MODEL]["rng"].dtype == np.uint32
    path = str(tmp_path / "sched.npz")
    faults.save_checkpoint(path, state)
    assert _walk_equal(faults.load_checkpoint(path), state)
    fresh, _, _ = storm("torch", engines, names, N, serve=False)
    fresh.load_state_dict(faults.load_checkpoint(path))
    assert _walk_equal(fresh.state_dict(), state)
    assert fresh._svcs[MODEL]._rng.dtype == np.uint32
    assert fresh.pending() == sched.pending() > 0
    assert len(fresh.completions) == len(sched.completions)


def test_load_state_dict_rejects_mismatched_registration(engines):
    sched, _, trace = storm("torch", engines, (MODEL,), N, serve=False)
    sched.serve_trace(trace, stop_at=0.01)
    state = sched.state_dict()
    with pytest.raises(ValueError):
        ContinuousBatchingScheduler(clock="modeled").load_state_dict(state)
    with pytest.raises(ValueError, match="version"):
        sched.load_state_dict({"version": 2})


def test_stop_at_absorbs_exactly_the_elapsed_arrivals(engines):
    sched, _, trace = storm("torch", engines, (MODEL,), N, serve=False)
    now = sched.serve_trace(trace, stop_at=0.02)
    assert now >= 0.02 - 1e-12
    due = [e for e in trace if e[0] <= now + 1e-12]
    assert len(sched.completions) + sched.pending() == len(due)


def test_drift_report_window_semantics(engines):
    ts, tc, _ = storm("torch", engines, (MODEL,), N, seed=0)
    js, jc, _ = storm("jax", engines, (MODEL,), N, seed=0)
    end = max(d.started + d.service_time for d in ts.dispatches)
    empty = tc.drift_report(ts, window_s=1e-6, now=end + 100.0)
    assert empty[MODEL] and all(r is None for r in empty[MODEL].values())
    full = tc.drift_report(ts, window_s=end + 1.0, now=end)
    assert full == jc.drift_report(js, window_s=end + 1.0, now=end)
    used = {(d.backend, d.rung) for d in ts.dispatches if not d.failed}
    for cell, r in full[MODEL].items():
        b, rung = cell.split("/b")
        if (b, int(rung)) in used:
            assert r == pytest.approx(1.0)
        else:
            assert r is None
    assert all(r == 1.0 for r in tc.drift_report(ts)[MODEL].values())


def test_midstorm_checkpoint_roundtrip_is_dispatch_identical(engines,
                                                             tmp_path):
    """A watchdog reboot in the middle of a fault storm: {scheduler,
    controller} state restored into fresh twins resumes the timeline
    dispatch-for-dispatch, and the resumed ledger equals the
    uninterrupted run's and the reference's."""
    storm_cfg = dict(seed=0, self_test_period=0.01,
                     upsets=((0.005,), (0.008, "mbu", 3), (0.038,),
                             (0.045, "mbu", 2)))
    full, ctl_full, trace = storm("torch", engines, (MODEL,), N,
                                  **storm_cfg)
    _, ctl_ref, _ = storm("jax", engines, (MODEL,), N, **storm_cfg)
    first, ctl_first, _ = storm("torch", engines, (MODEL,), N,
                                serve=False, **storm_cfg)
    cut = first.serve_trace(trace, stop_at=0.03)
    assert all(e.recovered_at is not None for e in ctl_first.events)
    assert ctl_first._pending
    path = str(tmp_path / "midstorm.npz")
    faults.save_checkpoint(path, {"sched": first.state_dict(),
                                  "faults": ctl_first.state_dict()})
    second, ctl_second, _ = storm("torch", engines, (MODEL,), N,
                                  serve=False, **storm_cfg)
    ck = faults.load_checkpoint(path)
    second.load_state_dict(ck["sched"])
    ctl_second.load_state_dict(ck["faults"])
    second.serve_trace([e for e in trace if e[0] > cut + 1e-12], start=cut)
    rep = ctl_second.report()
    assert rep["n_injected"] == 4
    assert rep["n_detected"] == rep["n_recovered"] == 4
    assert sorted(c.rid for c in second.completions) == list(range(N))
    assert second.dispatches == full.dispatches
    assert _meta(second) == _meta(full)
    assert _events(ctl_second) == _events(ctl_full) == _events(ctl_ref)


def test_watchdog_reboot_loses_nothing(engines, tmp_path):
    names = (MODEL, CO_MODEL)
    full, _, trace = storm("torch", engines, names, N)
    first, _, _ = storm("torch", engines, names, N, serve=False)
    now = first.serve_trace(trace, stop_at=0.02)
    path = str(tmp_path / "reboot.npz")
    faults.save_checkpoint(path, first.state_dict())
    second, _, _ = storm("torch", engines, names, N, serve=False)
    second.load_state_dict(faults.load_checkpoint(path))
    second.serve_trace([e for e in trace if e[0] > now + 1e-12], start=now)
    assert sorted(c.rid for c in second.completions) == \
        list(range(len(trace)))
    assert _meta(second) == _meta(full)
    assert second.dispatches == full.dispatches
    by_rid = {c.rid: c for c in full.completions}
    post = [c for c in second.completions if c.outputs]
    assert post, "no post-reboot completion exercised the restored queue"
    for c in post:
        for k in c.outputs:
            np.testing.assert_array_equal(c.outputs[k],
                                          by_rid[c.rid].outputs[k])


# ---------------------------------------------------------------------------
# the launcher's usage errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--protection", "ecc"], ["--base-upset-rate", "3"],
    ["--saa-factor", "2"], ["--checkpoint-cadence", "auto"],
    ["--fault-rate", "1", "--backend", "flex"],
    ["--radiation", "orbit", "--backend", "cpu,flex"],
    ["--self-test-period", "0.05", "--recovery", "demote"],
    ["--fault-seed", "3"], ["--recovery", "demote"]],
    ids=lambda f: " ".join(f))
def test_launcher_usage_errors_match_the_reference(flags):
    """Each half-specified fault/radiation flag set exits with the
    reference launcher's message, before any engine is built."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    argv = ["--mode", "space", "--model", "logistic_net", "--backend",
            "accel"] + flags
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jserve.main(argv)
    assert isinstance(got.value.code, str)
    assert got.value.code == want.value.code
