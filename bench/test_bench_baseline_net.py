"""The ``mms.stream`` cell on the CPU: the MMS BaselineNet served at its
published widths (the program's graph is fixed) by the program's plain
kernels, with a short window, a small frame pool and a stand-in for the
card's energy counter. A sound run comes out correct; the control, the
reference's ``fc1`` and ``head`` in int4, fails the ``head`` limit; a run
whose flex segment drops conv1's bias comes out not correct. The counts
of the 3-D layers are held to their bounds worked out by hand, and the
``conv3d_roofline`` reader to a hand-made trace.
"""
import json
import time

import pytest
import torch

from bench import control, harness
from bench import run as bench_run
from bench.devtrace import DeviceEvent, TraceData
from bench.test_bench_run import StandInEnergy

CELL = "mms.stream"
# the CPU keeps up with ten full batches a second; 32 pool frames keep the
# reference's recomputation short
POOL = {"pool_frames": 32}
RATE = {"rate_hz": 160.0}
H100 = harness.peaks("NVIDIA H100 80GB HBM3")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cpu(seed, seconds=0.5):
    m = harness.Manifest()
    return bench_run.run_cell(m, m.workload(CELL), seed, seconds, False,
                              device="cpu", t_start=time.monotonic(),
                              energy_source=StandInEnergy(), overrides=POOL,
                              traffic_overrides=RATE)


def test_sound_run_is_correct(one_thread):
    r = run_cpu(2 ** 31 + 17)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["check"]["answers_missing"]["value"] == 0
    assert set(r["metrics"]) == {"setup_s", "latency_p95_ms",
                                 "energy_mJ_per_inf"}


def test_control_fails_the_head_limit(one_thread):
    """The reference with ``fc1`` and ``head`` in int4 in the program's
    place passes the ``head`` limit on three seeds; the program does
    not."""
    m = harness.Manifest()
    w = m.workload(CELL)
    limit = m.config(w["config"])["check"]["limits"]["head"]
    for seed in (1, 2, 3):
        prog, ctl, n = control.readings(m, w, seed, 0.3, torch.device("cpu"),
                                        POOL, RATE)
        assert n > 0
        assert prog["head_gap"] <= limit, prog
        assert ctl["head_gap"] > limit, ctl


def test_flex_segment_without_conv1_bias_is_not_correct(one_thread,
                                                        monkeypatch):
    """A fault inside the flex path: conv1 (the 3-D convolution whose
    input has 16 channels) served without its bias."""
    from repro_torch.core import plan as plan_mod
    orig = plan_mod._conv_b

    def no_bias(x, p, a, nd):
        if nd == 3 and p["w"].shape[-2] == 16:
            p = dict(p, b=torch.zeros_like(p["b"]))
        return orig(x, p, a, nd)

    monkeypatch.setattr(plan_mod, "_conv_b", no_bias)
    r = run_cpu(9)
    assert not r["correct"], r["check"]


def _convs():
    m = harness.Manifest()
    cfg = m.config("baseline_net")
    return {x["name"]: x for x in harness.reference("baseline_net").layers(cfg)
            if x["op"] in ("conv3d", "maxpool3d")}


def test_conv3d_bounds_at_b16():
    """At B=16: conv0 (32x16x32x1 -> 16) writes a 16.8 MB fp32 map and is
    bound by its bytes, 5.32 us; conv1 (16x8x16x16 -> 48) does 1.36
    GFLOP and is bound by the fp32 peak, 20.28 us."""
    layers = _convs()
    c = harness.counts("conv3d")
    conv0, conv1 = layers["conv0"], layers["conv1"]
    assert c.nbytes(conv0, 16) == (16 * 16384 * 4 + 27 * 16 * 4 + 16 * 4
                                   + 16 * 16384 * 16 * 4)
    assert c.mac_ops(conv1, 16) == 2 * 16 * 2048 * 48 * 27 * 16
    t = {name: (c.mac_ops(x, 16) / H100["fp32"],
                c.nbytes(x, 16) / H100["hbm_bytes_s"])
         for name, x in (("conv0", conv0), ("conv1", conv1))}
    assert t["conv0"][1] > t["conv0"][0]
    assert t["conv0"][1] == pytest.approx(5.32e-6, abs=0.01e-6)
    assert t["conv1"][0] > t["conv1"][1]
    assert t["conv1"][0] == pytest.approx(20.28e-6, abs=0.01e-6)
    p = harness.counts("maxpool3d")
    pool0 = layers["pool0"]
    assert p.ops(pool0, 16) == 16 * 16 * 8 * 16 * 16 * 8
    assert p.nbytes(pool0, 16) == 4 * 16 * (32 * 16 * 32 * 16
                                            + 16 * 8 * 16 * 16)


def test_conv3d_roofline_reads_only_the_convolution_kernels():
    """Two B=16 dispatches: the least time of both convs at B=16, twice,
    over the device time of the kernels named in
    ``library/conv3d_f32.json``; pools, layout transforms and the split-K
    are left out, and a stretch without such a kernel reads nothing."""
    m = harness.Manifest()
    cfg = m.config("baseline_net")
    frag = harness.BENCH / "library" / "conv3d_f32.json"
    name = json.loads(frag.read_text())["match"][0]
    dev = [DeviceEvent(f"void {name}<float>(...)", "kernel", 0, 40_000),
           DeviceEvent("void cudnn::ops::nchwToNhwcKernel<float>(...)",
                       "kernel", 40_000, 5_000),
           DeviceEvent("max_pool3d_with_indices_single_out_frame", "kernel",
                       45_000, 10_000),
           DeviceEvent("void int8_matmul_kernel<4>(...)", "kernel",
                       55_000, 15_000),
           DeviceEvent(f"void {name}<float>(...)", "kernel", 90_000,
                       40_000)]

    def run_of(events):
        tr = TraceData(events, [], 1e-3, [(16, 16), (16, 16)])
        return harness.Run({"name": CELL}, cfg, {}, 2.0, 7.5,
                           harness.Window(0, 1, None), [], cfg["deadline_s"],
                           harness.reference("baseline_net").layers(cfg),
                           H100, tr)

    c = harness.counts("conv3d")
    least = 2 * sum(max(c.mac_ops(x, 16) / H100["fp32"],
                        c.nbytes(x, 16) / H100["hbm_bytes_s"])
                    for x in _convs().values() if x["op"] == "conv3d")
    reader = harness.metric_reader("conv3d_roofline")
    assert reader.read(run_of(dev)) == pytest.approx(100 * least / 80e-6)
    assert reader.read(run_of(dev[1:4])) is None
