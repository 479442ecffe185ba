"""The port's radiation layer (``core/radiation.py``, a verbatim copy, and
the MBU, protection and control-path handling in ``core/faults.py``) held
against the JAX reference's, on the reference radiation tests' engine:
``multi_esperta`` with the reference's params and 2-sample calibration
carried over as numpy, served on ``("accel", "cpu")`` over the ladder
(1, 4) under the modeled clock.

Held exactly: the environment's rates, integrals, sampled schedules and
cadence plans; the MBU burst the injector draws and the bytes it flips;
protection pricing and the re-priced signatures; ``choose_protection``'s
table; and every storm's event ledger and ``report()`` (mixed orbit
storms, ECC correct and scrub, TMR mask, the ladder, queue and tuning
control upsets), which the modeled clock makes deterministic.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import dataclasses
import json

import numpy as np

from repro.core import faults as jfaults
from repro.core import radiation as jrad
from repro.core.autotune import TuningCache as JTuningCache
from repro.models import synthetic_requests
from repro_torch.core import energy, faults, memory, radiation
from repro_torch.core.autotune import TuningCache
from test_torch_support import fault_twins, storm

MODEL = "multi_esperta"             # int8 dense heads -> real arenas
N = 16


@pytest.fixture(scope="module")
def engines():
    return fault_twins((MODEL,))


@pytest.fixture(autouse=True)
def pristine(engines):
    yield
    for _, je, te in engines.values():
        je.planned("accel").repack_weights()
        te.planned("accel").repack_weights()


@pytest.fixture()
def plans(engines):
    _, je, te = engines[MODEL]
    return je.planned("accel"), te.planned("accel")


def _arena_pristine(plan) -> bool:
    return all(np.array_equal(a.numpy(), plan.host_weights[n])
               for n, a in plan.weight_arena.items())


def _twin(engines, **kw):
    """The same storm on both packages: (port sched, port ctl, ref ctl)."""
    ts, tc, _ = storm("torch", engines, (MODEL,), N, **kw)
    js, jc, _ = storm("jax", engines, (MODEL,), N, **kw)
    assert tc.report() == jc.report()
    assert [dataclasses.asdict(d) for d in ts.dispatches] == \
        [dataclasses.asdict(d) for d in js.dispatches]
    assert sorted(c.rid for c in ts.completions) == list(range(N))
    return ts, tc, jc


# ---------------------------------------------------------------------------
# the environment (a verbatim copy: held against the reference's numbers)
# ---------------------------------------------------------------------------


def test_orbit_geometry_and_rates():
    env, jenv = radiation.RadiationEnvironment(), jrad.RadiationEnvironment()
    assert env.orbit_s == pytest.approx(0.5)
    assert [env.phase_of(t) for t in (0.05, 0.17, 0.25, 0.45, 1.55)] == \
        ["sunlight", "penumbra", "eclipse", "sunlight", "sunlight"]
    assert env.in_saa(0.25) and not env.in_saa(0.05)
    assert env.rate(0.25) == pytest.approx(env.base_rate * 1.3 * 40.0)
    grid = np.linspace(0.0, env.orbit_s, 2001)
    assert [env.rate(t) for t in grid] == [jenv.rate(t) for t in grid]
    assert max(env.rate(t) for t in grid) == pytest.approx(env.rate_bound())
    assert env.rate_bound() == jenv.rate_bound()


def test_expected_upsets_matches_reference_and_analytic_integral():
    env = radiation.RadiationEnvironment()
    saa_w = env.saa_window[1] - env.saa_window[0]
    analytic = env.base_rate * (
        0.15 * 1.0 + 0.05 * 1.15 + 0.15 * 1.3 + 0.05 * 1.15 + 0.10 * 1.0
        + (env.saa_factor - 1.0) * 1.3 * saa_w)
    got = env.expected_upsets(0.0, env.orbit_s)
    assert got == pytest.approx(analytic, rel=1e-2)
    assert got == jrad.RadiationEnvironment().expected_upsets(0.0,
                                                              env.orbit_s)


@pytest.mark.parametrize("seed,horizon", [(3, 2.0), (4, 2.0), (0, 0.3),
                                          (7, 0.0)])
def test_sample_upsets_match_reference(seed, horizon):
    env = radiation.RadiationEnvironment()
    a = env.sample_upsets(seed=seed, horizon_s=horizon)
    assert a == env.sample_upsets(seed=seed, horizon_s=horizon)
    assert [dataclasses.astuple(ev) for ev in a] == [
        dataclasses.astuple(ev) for ev in
        jrad.RadiationEnvironment().sample_upsets(seed, horizon)]
    ts = [ev.t for ev in a]
    assert ts == sorted(ts) and all(0.0 <= t < horizon for t in ts)
    if horizon >= 2.0:
        assert {ev.kind for ev in a} == {"single", "mbu", "control"}


def test_uncorrectable_fraction():
    env = radiation.RadiationEnvironment()
    mix = dict(env.mix)
    arena_w = mix["single"] + mix["mbu"]
    assert env.uncorrectable_fraction(4) == pytest.approx(
        mix["mbu"] * (4 / 7) / arena_w)
    assert env.uncorrectable_fraction(8) == 0.0
    for d in (1, 2, 4, 8):
        assert env.uncorrectable_fraction(d) == \
            jrad.RadiationEnvironment().uncorrectable_fraction(d)


def test_upset_event_validation():
    with pytest.raises(ValueError, match="kind"):
        radiation.UpsetEvent(0.0, kind="tripleplay")
    with pytest.raises(ValueError, match="span"):
        radiation.UpsetEvent(0.0, kind="mbu", span=0)
    with pytest.raises(ValueError, match="target"):
        radiation.UpsetEvent(0.0, kind="control", target="fpga")
    with pytest.raises(ValueError, match="saa_window"):
        radiation.RadiationEnvironment(saa_window=(0.4, 0.3))
    with pytest.raises(ValueError, match="sum to 1"):
        radiation.RadiationEnvironment(mix=(("single", 0.5),))


# ---------------------------------------------------------------------------
# MBU injection + ECC domain interleaving
# ---------------------------------------------------------------------------


def test_flip_mbu_pinned_burst_shape(plans):
    _, tp = plans
    node = max(tp.weight_arena, key=lambda n: tp.host_weights[n].nbytes)
    got = faults.SEUInjector(seed=0).flip_mbu(tp, span=2, node=node, byte=1)
    assert got == (node, 1, 2)
    diff = (tp.host_weights[node].view(np.uint8).reshape(-1)
            ^ tp.weight_arena[node].numpy().view(np.uint8).reshape(-1))
    assert list(np.nonzero(diff)[0]) == [1, 2]
    assert all(bin(int(diff[b])).count("1") == 1 for b in (1, 2))


@pytest.mark.parametrize("seed,span", [(9, 5), (0, 2), (3, 8)])
def test_flip_mbu_matches_reference(plans, seed, span):
    jp, tp = plans
    got = faults.SEUInjector(seed).flip_mbu(tp, span=span)
    assert got == jfaults.SEUInjector(seed).flip_mbu(jp, span=span)
    for n, a in tp.weight_arena.items():
        assert np.array_equal(a.numpy(), np.asarray(jp.weight_arena[n]))


def test_flip_mbu_clamped_to_the_entry(plans):
    _, tp = plans
    node = min(tp.weight_arena, key=lambda n: tp.host_weights[n].nbytes)
    nbytes = tp.host_weights[node].nbytes
    _, byte, span = faults.SEUInjector(seed=0).flip_mbu(
        tp, span=nbytes + 100, node=node)
    assert span == nbytes and byte == 0


def test_protection_domain_interleaving():
    plan = memory.plan_protection_domains(1024, n_domains=4)
    assert [plan.domain_of(b) for b in range(6)] == [0, 1, 2, 3, 0, 1]
    assert [plan.worst_hit(s) for s in range(1, 10)] == \
        [-(-s // 4) for s in range(1, 10)]
    assert plan.correctable(4) and not plan.correctable(5)
    naive = memory.plan_protection_domains(1024, 4, interleaved=False)
    assert naive.correctable(1) and not naive.correctable(2)
    assert max(naive.domains_hit(8, 4).values()) == 4
    assert memory.protected_weight_bytes(1000, "ecc") == 1125
    assert memory.protected_weight_bytes(1024, "tmr") == 3072


# ---------------------------------------------------------------------------
# protection pricing
# ---------------------------------------------------------------------------


def test_protection_cost_pricing():
    hw = energy.BACKEND_HW["accel"]
    pb = 1 << 16
    ecc = energy.protection_cost(hw, pb, "ecc", scrub_period_s=0.05)
    assert ecc.protected_bytes == (pb * 9 + 7) // 8
    assert ecc.scrub_s == pytest.approx(
        ecc.protected_bytes / (hw.stage_bw or hw.hbm_bw))
    tmr = energy.protection_cost(hw, pb, "tmr")
    assert tmr.protected_bytes == 3 * pb and tmr.power_copies == 3
    assert tmr.latency_factor > ecc.latency_factor > 1.0
    none = energy.protection_cost(hw, pb, "none")
    assert none.scrub_power_w == 0.0 and none.latency_factor == 1.0


def test_protected_signature_repricing(engines):
    sched, _, _ = storm("torch", engines, (MODEL,), N, serve=False)
    sig = sched._svcs[MODEL].costs[("accel", 1)]
    hw = energy.BACKEND_HW["accel"]
    pb = 1 << 16
    assert energy.protected_signature(
        sig, hw, energy.protection_cost(hw, pb, "none")) is sig
    ecc = energy.protected_signature(
        sig, hw, energy.protection_cost(hw, pb, "ecc"))
    tmr = energy.protected_signature(
        sig, hw, energy.protection_cost(hw, pb, "tmr"))
    assert (ecc.protection, tmr.protection) == ("ecc", "tmr")
    assert tmr.j_per_inference > ecc.j_per_inference > sig.j_per_inference
    assert tmr.power_w == pytest.approx(hw.power_busy * 3)


@pytest.mark.parametrize("mode", ["ecc", "tmr"])
def test_apply_protection_swaps_signatures_and_reseeds(engines, mode):
    ts, tc, _ = storm("torch", engines, (MODEL,), N, serve=False,
                      protection=mode, self_test_period=0.05)
    js, jc, _ = storm("jax", engines, (MODEL,), N, serve=False,
                      protection=mode, self_test_period=0.05)
    svc, jsvc = ts._svcs[MODEL], js._svcs[MODEL]
    assert svc.protection == mode
    am = tc._models[MODEL]
    assert am.domains.total_bytes == sum(
        a.numel() for a in am.plan.weight_arena.values())
    assert dataclasses.asdict(am.protection_cost) == \
        dataclasses.asdict(jc._models[MODEL].protection_cost)
    for key, sig in svc.costs.items():
        assert dataclasses.asdict(sig) == dataclasses.asdict(jsvc.costs[key])
        assert sig.protection == (mode if key[0] == "accel" else "none")
    assert svc.est_service == jsvc.est_service
    assert all(svc.est_service[("accel", r)] ==
               svc.costs[("accel", r)].latency_s for r in (1, 4))
    with pytest.raises(KeyError):
        ts.apply_protection(MODEL, mode,
                            {("accel", 999): svc.costs[("accel", 1)]})


def test_choose_protection_matches_reference_and_flips(engines):
    ts, tc, _ = storm("torch", engines, (MODEL,), N, serve=False,
                      self_test_period=0.05)
    js, jc, _ = storm("jax", engines, (MODEL,), N, serve=False,
                      self_test_period=0.05)
    sig = ts._svcs[MODEL].costs[("accel", 4)]
    jsig = js._svcs[MODEL].costs[("accel", 4)]
    cost = tc._models[MODEL].canary.cost
    pb = 1 << 20                    # a CNN-scale arena (see the reference)
    env = radiation.RadiationEnvironment()
    p_unc = env.uncorrectable_fraction(4)
    picks = {}
    for where, t in (("quiet", 0.05), ("saa", 0.25)):
        best, table = faults.choose_protection(
            "accel", sig, pb, cost, upset_rate=env.rate(t),
            p_uncorrectable=p_unc)
        assert (best, table) == jfaults.choose_protection(
            "accel", jsig, pb, jc._models[MODEL].canary.cost,
            upset_rate=env.rate(t), p_uncorrectable=p_unc)
        picks[where] = (best, table)
    assert picks["quiet"][0] == "none" and picks["saa"][0] == "ecc"
    q = picks["quiet"][1]
    assert q["none"] < q["ecc"] < q["tmr"]
    with pytest.raises(ValueError, match="self_test_period"):
        faults.choose_protection("accel", sig, 1024, cost, 1.0,
                                 self_test_period=0.0)
    with pytest.raises(ValueError, match="upset_rate"):
        faults.choose_protection("accel", sig, 1024, cost, -1.0)


# ---------------------------------------------------------------------------
# the controller under typed storms (modeled clock), against the reference
# ---------------------------------------------------------------------------


def test_mixed_storm_detected_recovered_zero_loss(engines):
    ts, tc, _ = _twin(engines, self_test_period=0.02,
                      upsets=((0.008,), (0.015, "mbu", 6),
                              (0.022, "control", 1, "ladder")))
    rep = tc.report()
    assert rep["n_injected"] == rep["n_detected"] == rep["n_recovered"] == 3
    for kind in ("single", "mbu", "control"):
        assert rep["per_class"][kind]["n_recovered"] == 1
    bound = 0.02 * (1 + tc.config.aging_fraction) + 0.01
    for kind in ("single", "mbu"):
        assert rep["per_class"][kind]["max_detection_latency_s"] <= bound
    assert _arena_pristine(tc._models[MODEL].plan)


def test_sampled_orbit_storm_matches_reference(engines):
    """A launcher-shaped storm: the schedule sampled from a hot orbit
    (every class lands), canary detection at the radiation default."""
    env = radiation.RadiationEnvironment(base_rate=200.0)
    upsets = [dataclasses.astuple(ev) for ev in env.sample_upsets(2, 0.06)]
    assert {u[1] for u in upsets} == {"single", "mbu", "control"}
    _, tc, _ = _twin(engines, seed=2, self_test_period=0.05, upsets=upsets)
    rep = tc.report()
    assert all(rep["per_class"][k]["n_injected"] >= 1
               for k in ("single", "mbu", "control"))
    assert rep["n_detected"] == rep["n_recovered"] == rep["n_injected"]


def test_ecc_corrects_short_burst_at_injection(engines):
    _, tc, _ = _twin(engines, protection="ecc", interleave_domains=4,
                     self_test_period=0.05, upsets=((0.005, "mbu", 3),))
    (ev,) = tc.report()["events"]
    assert ev["action"] == "ecc-correct"
    assert ev["detected_at"] == ev["t_injected"]
    assert tc.n_corrected == 1 and tc.injector.n_flips == 0
    assert tc.n_scrubs > 0
    assert _arena_pristine(tc._models[MODEL].plan)


def test_ecc_uncorrectable_burst_caught_by_scrub(engines):
    _, tc, _ = _twin(engines, protection="ecc", interleave_domains=4,
                     scrub_period_s=0.03, self_test_period=0.5,
                     upsets=((0.005, "mbu", 8),))
    (ev,) = tc.report()["events"]
    assert ev["action"] == "scrub+repack"
    assert tc.injector.n_flips > 0 and ev["span"] <= 8
    assert ev["detected_at"] - ev["t_injected"] <= 0.03 + 0.01
    assert _arena_pristine(tc._models[MODEL].plan)


def test_tmr_masks_all_arena_upsets(engines):
    _, tc, _ = _twin(engines, protection="tmr", self_test_period=0.05,
                     upsets=((0.004,), (0.009, "mbu", 8)))
    rep = tc.report()
    assert [e["action"] for e in rep["events"]] == ["tmr-mask"] * 2
    assert tc.n_corrected == 2 and tc.injector.n_flips == 0
    assert rep["max_detection_latency_s"] == 0.0
    assert _arena_pristine(tc._models[MODEL].plan)


# ---------------------------------------------------------------------------
# control-path upsets + structural checks
# ---------------------------------------------------------------------------


def _armed_pair(engines):
    ts, tc, _ = storm("torch", engines, (MODEL,), N, serve=False,
                      self_test_period=0.05)
    js, jc, _ = storm("jax", engines, (MODEL,), N, serve=False,
                      self_test_period=0.05)
    return (ts, tc), (js, jc)


def test_control_ladder_corruption_restored_from_shadow(engines):
    pair = _armed_pair(engines)
    for sched, ctl in pair:
        svc = sched._svcs[MODEL]
        before = dict(svc.est_service)
        ctl._inject(sched, radiation.UpsetEvent(0.0, "control",
                                                target="ladder"))
        assert any(est > ctl._EST_BAND * svc.costs[k].latency_s
                   for k, est in svc.est_service.items())
        assert ctl._control_check(sched, 0.001) > 0.001
        assert svc.est_service == before
        (ev,) = ctl.events
        assert ev.action == "control-restore" and ev.target == "ladder"
    (_, tc), (_, jc) = pair
    assert tc.report() == jc.report()


def test_control_queue_deadline_rebuilt(engines):
    m, _, _ = engines[MODEL]
    pair = _armed_pair(engines)
    for sched, ctl in pair:
        svc = sched._svcs[MODEL]
        sched.submit(MODEL, synthetic_requests(m, 1, seed=5)[0],
                     arrival=0.0)
        ctl._inject(sched, radiation.UpsetEvent(0.0, "control",
                                                target="queue"))
        assert svc.queue[0].deadline > 1e6
        ctl._control_check(sched, 0.001)
        assert svc.queue[0].deadline == pytest.approx(svc.deadline_s)
        (ev,) = ctl.events
        assert ev.action == "control-rebuild" and ev.target == "queue"
    (_, tc), (_, jc) = pair
    assert tc.report() == jc.report()


def test_control_tuning_cache_rewritten(engines, tmp_path):
    pair = _armed_pair(engines)
    for (sched, ctl), cls, tag in zip(pair, (TuningCache, JTuningCache),
                                      ("t", "j")):
        path = str(tmp_path / f"tuning_{tag}.json")
        cache = cls(path)
        cache.put("k1", {"block": [8, 8]})
        cache.save()
        ctl.attach_tuning_cache(cache)
        ctl._inject(sched, radiation.UpsetEvent(0.0, "control",
                                                target="tuning"))
        with open(path, "w", encoding="utf-8") as f:
            f.write("{ not json at all")
        ctl._control_check(sched, 0.001)
        (ev,) = ctl.events
        assert ev.action == "control-rewrite" and ev.target == "tuning"
        with open(path, encoding="utf-8") as f:
            assert json.load(f)["entries"]["k1"] == {"block": [8, 8]}
    (_, tc), (_, jc) = pair
    assert [(e.byte, e.action) for e in tc.events] == \
        [(e.byte, e.action) for e in jc.events]


def test_control_fault_without_target_falls_back_to_ladder(engines):
    pair = _armed_pair(engines)
    for sched, ctl in pair:
        for i in range(4):
            ctl._inject(sched, radiation.UpsetEvent(float(i), "control"))
        assert len(ctl.events) == 4
        assert all(ev.target in radiation.CONTROL_TARGETS
                   for ev in ctl.events)
        ctl._control_check(sched, 1.0)
        assert all(ev.recovered_at is not None for ev in ctl.events
                   if ev.target != "staging")
    (_, tc), (_, jc) = pair
    assert tc.report() == jc.report()


def test_controller_state_dict_roundtrip(engines, tmp_path):
    cfg = dict(upsets=((0.005,), (0.3, "mbu", 4)), self_test_period=0.02)
    _, ctl, _ = storm("torch", engines, (MODEL,), N, stop_at=0.05, **cfg)
    _, jctl, _ = storm("jax", engines, (MODEL,), N, stop_at=0.05, **cfg)
    state = ctl.state_dict()
    assert state == jctl.state_dict()
    path = str(tmp_path / "ctl.npz")
    faults.save_checkpoint(path, state)
    _, ctl2, _ = storm("torch", engines, (MODEL,), N, serve=False, **cfg)
    ctl2.load_state_dict(faults.load_checkpoint(path))
    assert ctl2.state_dict() == state
    assert ctl2.injector._rng.bit_generator.state == \
        ctl.injector._rng.bit_generator.state
    with pytest.raises(ValueError, match="version"):
        ctl2.load_state_dict({"version": 99})


# ---------------------------------------------------------------------------
# checkpoint-cadence optimization
# ---------------------------------------------------------------------------


def test_expected_replay_cost_shape():
    env = radiation.RadiationEnvironment()
    c = 1e-3
    with pytest.raises(ValueError, match="positive"):
        radiation.expected_replay_cost(env, 1.0, 0.0, c)
    with pytest.raises(ValueError, match="checkpoint_cost_s"):
        radiation.expected_replay_cost(env, 1.0, 0.1, -1.0)
    mid = radiation.expected_replay_cost(env, 1.0, 0.01, c)
    assert radiation.expected_replay_cost(env, 1.0, 1e-4, c) > mid
    assert radiation.expected_replay_cost(env, 1.0, 1.0, c) > mid
    assert mid == jrad.expected_replay_cost(jrad.RadiationEnvironment(),
                                            1.0, 0.01, c)


@pytest.mark.parametrize("base_rate", [0.5, 2.0, 50.0])
def test_optimize_cadence_matches_reference(base_rate):
    env = radiation.RadiationEnvironment(base_rate=base_rate)
    plan = radiation.optimize_cadence(env, horizon_s=1.0,
                                      checkpoint_cost_s=1e-3)
    assert dataclasses.astuple(plan) == dataclasses.astuple(
        jrad.optimize_cadence(jrad.RadiationEnvironment(base_rate=base_rate),
                              horizon_s=1.0, checkpoint_cost_s=1e-3))
    assert plan.n_checkpoints == int(np.ceil(1.0 / plan.cadence_s))
    for k in (0.1, 10.0):
        assert plan.expected_cost_s < radiation.expected_replay_cost(
            env, 1.0, plan.cadence_s * k, 1e-3)


def test_optimize_cadence_tracks_upset_rate():
    tq = radiation.optimize_cadence(
        radiation.RadiationEnvironment(base_rate=0.5), 1.0, 1e-3).cadence_s
    th = radiation.optimize_cadence(
        radiation.RadiationEnvironment(base_rate=50.0), 1.0, 1e-3).cadence_s
    assert th < tq
