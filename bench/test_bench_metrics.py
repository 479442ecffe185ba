"""The metric readers, the trace reduction, the energy integral and the
generators, on small hand-made records (CPU only)."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import devtrace, energy, harness, loads
from bench.devtrace import DeviceEvent, HostSpan, TraceData

MANIFEST = json.loads(
    (Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
H100 = harness.peaks("NVIDIA H100 80GB HBM3")


def read(name, run):
    return harness.metric_reader(name).read(run)


def _run(reqs, window, trace=None, cfg_name="cnet_plus_scalar",
         trace_from=None, seconds=2.0):
    m = harness.Manifest()
    cfg = m.config(cfg_name)
    ref = harness.reference(cfg_name)
    run = harness.Run({"name": "x"}, cfg, {}, seconds, 7.5, window, reqs,
                      cfg["deadline_s"], ref.layers(cfg), H100, trace,
                      trace_from)
    return run


def _req(rid, due, answered, dispatched=None, tail=False):
    return harness.Req(rid, rid % 4, due, due, answered, dispatched, rid, 0,
                       1, tail)


def test_end_to_end_readers():
    w = harness.Window(10.0, 12.0, energy_j=30.0, gave_up_at=15.0)
    reqs = [_req(0, 10.0, 10.01, 10.001), _req(1, 10.5, 10.52, 10.505),
            _req(2, 11.0, None), _req(3, 11.9, 12.4, 11.95),
            _req(4, 12.1, 12.2), _req(5, 11.0, 11.5, tail=True)]
    run = _run(reqs, w)
    # answered inside [10, 12]: rids 0 and 1 (the tail never counts)
    assert len(run.answered_in_window) == 2
    assert read("energy_mJ_per_inf", run) == pytest.approx(15000.0)
    assert read("setup_s", run) == 7.5
    # due in the window: 0, 1, 2, 3; latencies 10, 20, 4000 (gave up), 500
    lat = [0.01, 0.02, 4.0, 0.5]
    assert read("latency_p95_ms", run) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert read("sched_wait_ms", run) == pytest.approx(
        np.median([1.0, 5.0, 50.0]))
    assert read("retire_ms", run) == pytest.approx(
        np.median([9.0, 15.0, 450.0]))
    # a traced run reads the spans of requests due before its stretch
    run.trace_from = 10.9
    assert read("sched_wait_ms", run) == pytest.approx(3.0)


def test_cadence_readers_read_the_untraced_requests():
    """The single-frame cells' per-layer readings: the scheduler's wait and
    the retirement as the stream cells read them, and the p95 of the
    requests due before the traced stretch."""
    w = harness.Window(10.0, 12.0, energy_j=30.0, gave_up_at=15.0)
    reqs = [_req(0, 10.0, 10.01, 10.001), _req(1, 10.5, 10.52, 10.505),
            _req(2, 11.0, None), _req(3, 11.9, 12.4, 11.95)]
    run = _run(reqs, w)
    for name in ("sched_wait_ms", "retire_ms"):
        assert read(name + ".cadence", run) == read(name, run)
    assert read("latency_p95_ms.cadence", run) == read("latency_p95_ms", run)
    run.trace_from = 10.9
    assert read("latency_p95_ms.cadence", run) == pytest.approx(
        np.percentile([0.01, 0.02], 95) * 1e3)
    assert read("sched_wait_ms.cadence", run) == pytest.approx(3.0)
    assert read("latency_p95_ms.cadence", _run([], w)) is None


def _trace():
    conv = "void conv2d_int8_kernel<3, true>(ConvArgs)"
    dev = [DeviceEvent("Memcpy HtoD (Pinned -> Device)", "h2d", 0, 100_000),
           DeviceEvent(conv, "kernel", 100_000, 200_000),
           DeviceEvent("void int8_matmul_kernel<4>(...)", "kernel",
                       300_000, 20_000),
           DeviceEvent("max_pool2d_with_indices_out_cuda", "kernel",
                       250_000, 150_000),
           DeviceEvent("Memcpy DtoH (Device -> Pinned)", "d2h",
                       900_000, 10_000),
           DeviceEvent(conv, "kernel", 1_100_000, 200_000)]
    spans = [HostSpan("sched.step", 350_000, 1_050_000),
             HostSpan("pipeline.unstage", 500_000, 1_000_000)]
    return TraceData(dev, spans, wall_s=2e-3, rungs=[(16, 16), (16, 10)])


def test_trace_reduction_and_layer_readers():
    tr = _trace()
    # union: [0, 400us], [900, 910], [1100, 1300] -> 610 us busy
    assert tr.busy_s == pytest.approx(610e-6)
    run = _run([], harness.Window(0, 1, None), trace=tr)
    assert read("h2d_ms.stream", run) == pytest.approx(0.1 / 2)
    assert read("library_ms.stream", run) == pytest.approx(0.15 / 2)
    cfg = run.cfg
    ref = harness.reference("cnet_plus_scalar")
    convs = [x for x in ref.layers(cfg) if x["op"] == "conv2d"]
    c = harness.counts("conv2d")
    least = 2 * sum(max(c.mac_ops(x, 16) / 1.979e15,
                        c.nbytes(x, 16) / 3.35e12) for x in convs)
    assert read("conv2d_int8_roofline", run) == pytest.approx(
        100 * least / 400e-6)
    dense = [x for x in ref.layers(cfg) if x["op"] == "dense"]
    d = harness.counts("dense")
    least_d = 2 * sum(max(d.mac_ops(x, 16) / 1.979e15,
                          d.nbytes(x, 16) / 3.35e12) for x in dense)
    assert read("int8_matmul_roofline", run) == pytest.approx(
        100 * least_d / 20e-6)
    per_inf = sum(harness.counts(x["op"]).ops(x, 1) / H100[x["precision"]]
                  for x in ref.layers(cfg))
    # over the card's busy time, not the stretch's length
    assert read("step_mfu.stream", run) == pytest.approx(
        100 * 26 * per_inf / 610e-6)
    # a layer the demotion gate kept in fp32 leaves the int8 roofline
    run.layers = [dict(x, precision="fp32") if x["name"] == "head" else x
                  for x in run.layers]
    fc1 = [x for x in dense if x["name"] == "fc1"]
    least_fc1 = 2 * sum(max(d.mac_ops(x, 16) / 1.979e15,
                            d.nbytes(x, 16) / 3.35e12) for x in fc1)
    assert read("int8_matmul_roofline", run) == pytest.approx(
        100 * least_fc1 / 20e-6)
    b = devtrace.breakdown(tr)
    assert b["device_ops"][0] == [
        "void conv2d_int8_kernel<3, true>(ConvArgs)", 400e-6]
    gaps = dict(b["idle_gaps"])
    # 400->900 at 650 us: inside unstage; 910->1100 at 1005: sched.step
    assert gaps == {"pipeline.unstage": pytest.approx(500e-6),
                    "sched.step": pytest.approx(190e-6)}


def test_readers_leave_out_what_they_cannot_read():
    run = _run([], harness.Window(0, 1, None))
    for m in MANIFEST["per_layer"]:
        if m["source"] == "device_trace":
            assert read(m["name"], run) is None, m["name"]
    assert read("energy_mJ_per_inf", run) is None
    tr = TraceData([DeviceEvent("Memcpy HtoD", "h2d", 0, 10)], [], 1e-3,
                   [(16, 16)])
    run = _run([], harness.Window(0, 1, None), trace=tr)
    # no conv kernel in the stretch: no roofline, never a 0
    assert read("conv2d_int8_roofline", run) is None
    assert read("library_ms.stream", run) is None


def test_kind_of_device_events():
    assert devtrace.kind_of("Memcpy HtoD (Pinned -> Device)") == "h2d"
    assert devtrace.kind_of("Memcpy DtoH (Device -> Pageable)") == "d2h"
    assert devtrace.kind_of("Memset (Device)") == "memset"
    assert devtrace.kind_of("void at::native::foo") == "kernel"


def test_energy_integral():
    pts = [(0.0, 100.0), (1.0, 200.0), (2.0, 200.0)]
    assert energy.integrate(pts, 0.0, 2.0) == pytest.approx(350.0)
    # ends held at the interpolated reading
    assert energy.integrate(pts, 0.5, 1.5) == pytest.approx(
        0.5 * (150 + 200) * 0.5 + 0.5 * 200)
    with pytest.raises(energy.EnergyUnavailable):
        energy.integrate([], 0, 1)


def test_fixed_set_arrivals_are_deterministic_in_the_seed():
    f1 = loads.fixed_set_poisson(500.0, 1000, 2 ** 31 + 11)
    f2 = loads.fixed_set_poisson(500.0, 1000, 2 ** 31 + 11)
    f3 = loads.fixed_set_poisson(500.0, 1000, 7)
    assert np.array_equal(f1, f2) and not np.array_equal(f1, f3)
    assert f1[0] == 0.0 and np.all(np.diff(f1) > 0)
    # every seed offers the same gaps, in another order
    assert np.allclose(np.sort(np.diff(f1)), np.sort(np.diff(f3)))
    assert np.mean(np.diff(f1)) == pytest.approx(1 / 500.0, rel=0.01)


@pytest.mark.parametrize("rate", [80.0, 1000.0])
def test_window_arrivals_fix_the_windows_count(rate):
    """The window's gaps are one set for every seed, and the grace
    period's arrivals come after them: the count due in the window moves
    only by the few grace arrivals that land before its close, where one
    shuffle of all the gaps moved it by about 1% at 100/s."""
    seconds, grace = 20.0, 3.0
    n_win = int(round(rate * seconds))
    runs = [loads.window_arrivals(rate, seconds, grace, 2 ** 31 + s)
            for s in range(40)]
    counts = {int(np.sum(o < seconds)) for o in runs}
    assert min(counts) >= n_win + 1 and max(counts) - min(counts) <= 3
    for o in runs:
        assert o[0] == 0.0 and np.all(np.diff(o) > 0)
        assert o[-1] >= seconds + grace
    assert np.allclose(np.sort(np.diff(runs[0][:n_win + 1])),
                       np.sort(np.diff(runs[1][:n_win + 1])))
    assert not np.array_equal(runs[0], runs[1])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_seed_offers_a_cell_the_same_work(cell):
    """The arrivals a run schedules for its window, on two large seeds:
    the same count to within 0.5%, at the traffic's rate."""
    m = harness.Manifest()
    traffic = m.traffic(m.workload(cell)["traffic"])
    rate, seconds = float(traffic["rate_hz"]), float(MANIFEST["run_seconds"])
    due = [int(np.sum(loads.window_arrivals(rate, seconds, 3.0, s) < seconds))
           for s in (2 ** 31 + 5, 2 ** 32 + 9)]
    assert due[0] == pytest.approx(due[1], rel=0.005)
    assert due[0] == pytest.approx(rate * seconds, rel=0.01)


@pytest.mark.parametrize("config", ["cnet_plus_scalar", "vae_encoder"])
def test_frame_pool_and_weights_are_deterministic_in_the_seed(config):
    m = harness.Manifest()
    cfg = m.config(config)
    cfg.update(pool_frames=3, calibration_frames=2)
    ref = harness.reference(config)
    make_inputs = harness.system(cfg).make_inputs
    seed = 2 ** 33 + 5
    a = make_inputs(cfg, ref, seed, "cpu")
    b = make_inputs(cfg, ref, seed, "cpu")
    c = make_inputs(cfg, ref, seed + 1, "cpu")
    for k in a.pool:
        assert torch.equal(a.pool[k], b.pool[k])
        assert a.pool[k].shape[0] == 3
    assert not torch.equal(a.pool["image"], c.pool["image"])
    assert not torch.equal(a.calib["image"], a.pool["image"][:2])
    for node in a.params:
        assert torch.equal(a.params[node]["w"], b.params[node]["w"])
        assert not torch.equal(a.params[node]["w"], c.params[node]["w"])
        fan_in = math.prod(a.params[node]["w"].shape[:-1])
        gain = 2.0 if a.params[node]["w"].ndim == 4 else 1.0
        assert float(a.params[node]["w"].std()) == pytest.approx(
            math.sqrt(gain / fan_in), rel=0.5)


def test_served_key_chain():
    """The chain the reference derives for a served request: the
    service's raw key [0, u32(name[:4])], split per dispatch, then per
    row, then per random layer."""
    from bench.reference import common
    chain = common.ServedKeys("vae_encoder")
    word = int(np.frombuffer(b"vae_", np.uint32)[0])
    first = common.split(np.array([0, word], np.uint64), 2)
    assert np.array_equal(chain.dispatch_key(0), first[1])
    second = common.split(first[0], 2)
    assert np.array_equal(chain.dispatch_key(1), second[1])
    row = common.split(second[1], 17)[4]
    assert np.array_equal(chain.layer_key(1, 16, 3), common.split(row, 2)[1])
    eps = common.normal(chain.layer_key(0, 16, 0), 10000)
    assert abs(eps.mean()) < 0.05 and abs(eps.std() - 1) < 0.05
