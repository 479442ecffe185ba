"""The port's plan-time autotuner (``core/autotune.py``) against the JAX
reference's, and the kernel variants it selects.

* Pricing: candidate pools, prices, ``cache_key`` hex strings and search
  decisions equal the reference's exactly (the pricers are the same
  arithmetic on the same Python floats), at the signatures of the
  full-width ``cnet_plus_scalar`` and of the LM block at zamba2-1.2b
  widths. This is pure pricing: no weights, no kernels.
* Kernels: the port's plain ``conv2d_int8`` equals the reference's Pallas
  kernel (interpret mode, as its own tests run it) bit for bit for every
  ``conv_candidates`` config — the reference runs its channel-blocked grid
  there — and on the prepacked/pre-padded path; prepacked ``int8_matmul``
  is bit-exact too. The sigmoid/unfused-bias exceptions of
  tests/test_torch_kernels.py do not arise: these cases use relu or no
  act and requantize.
* The tuning cache: JSON round trip, zero evaluations when warm, stale
  schemas and corrupt files give a cold cache (the port of
  tests/test_autotune.py's cache tests).
* The launcher's ``--autotune``/``--tuning-cache``/``--autotune-measure``.

Engine-level checks (tuned plans, outputs, the LM) are in
tests/test_torch_autotune_engine.py.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import autotune as jat
from repro.core import energy as jenergy
from repro.kernels import ops as jops
from repro.models import cnet_plus_scalar as jcnet
from repro.models import lm as jlm
from repro_torch.core import autotune as tat
from repro_torch.core import energy as tenergy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import ops as tops
from repro_torch.kernels.epilogue import pad_channel_params
from repro_torch.launch import serve
from repro_torch.models import cnet_plus_scalar as tcnet
from repro_torch.models import lm as tlm
from test_torch_support import NARROW


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pricing, at full width, against the reference
# ---------------------------------------------------------------------------


def _stub_plan(graph, backend):
    """What ``node_spec`` reads of a plan, built from the graph alone: one
    quantized entry per conv2d/dense node with the weight shape the graph
    implies (``accel``), none on ``flex``."""
    qplans = {}
    if backend == "accel":
        for name in graph.order:
            node = graph.nodes[name]
            if node.op not in ("conv2d", "dense"):
                continue
            in_shape = graph.nodes[node.inputs[0]].out_shape
            n = node.out_shape[-1]
            if node.op == "conv2d":
                kh, kw = node.attrs["kernel"]
                w = (kh, kw, in_shape[-1], n)
            elif node.attrs.get("per_position"):
                w = (in_shape[-1], n)
            else:
                w = (int(np.prod(in_shape)), n)
            qplans[name] = types.SimpleNamespace(
                op="conv2d" if node.op == "conv2d" else "dense",
                w_q=types.SimpleNamespace(shape=w),
                per_position=bool(node.attrs.get("per_position")),
                stride=node.attrs.get("stride", 1),
                padding=node.attrs.get("padding", "SAME"))
    return types.SimpleNamespace(graph=graph, backend=backend,
                                 qplans=qplans)


def _graphs():
    """(name, port graph, reference graph, rungs) of the two full-width
    configurations."""
    jcfg = jlm.LMConfig(*tlm.ZAMBA2_1_2B)
    return [("cnet_plus_scalar", tcnet.build_graph(), jcnet.build_graph(),
             (1, 4, 16, 32)),
            ("zamba2_block", tlm.build_graph(tlm.ZAMBA2_1_2B),
             jlm.build_graph(jcfg), (1, 4))]


def _cfg(c):
    return c.to_dict()


def _dec(d):
    return (d.kind, d.config.to_dict(), d.modeled_s, d.default_s,
            d.extra_bytes, d.source)


@pytest.mark.parametrize("which", [0, 1], ids=["cnet", "zamba2"])
@pytest.mark.parametrize("backend", ["accel", "flex"])
def test_candidates_prices_keys_and_picks_equal_reference(which, backend):
    name, tg, jg, rungs = _graphs()[which]
    tplan, jplan = _stub_plan(tg, backend), _stub_plan(jg, backend)
    thw, jhw = tenergy.BACKEND_HW[backend], jenergy.BACKEND_HW[backend]
    assert dataclasses.asdict(thw) == dataclasses.asdict(jhw)
    tt, jt = tat.Autotuner(), jat.Autotuner()
    n_sigs = 0
    for rung in rungs:
        for node in tg.order:
            spec = tat.node_spec(tplan, node, rung)
            assert spec == jat.node_spec(jplan, node, rung), node
            if spec is None:
                continue
            kind, sig = spec
            n_sigs += 1
            cands = tt._candidates(kind, sig, None)
            assert [_cfg(c) for c in cands] == \
                [_cfg(c) for c in jt._candidates(kind, sig, None)]
            fixed = None
            if kind == "int8_dense":
                fixed = tat.KernelConfig(bn=cands[-1].bn, bk=cands[-1].bk)
            elif kind == "int8_conv":
                fixed = tat.KernelConfig(cout_per_block=8)
            if fixed is not None:
                jfixed = jat.KernelConfig(**fixed.to_dict())
                assert [_cfg(c) for c in tt._candidates(kind, sig, fixed)] \
                    == [_cfg(c) for c in jt._candidates(kind, sig, jfixed)]
            for resident in (True, False):
                for c in cands:
                    jc = jat.KernelConfig(**dataclasses.asdict(c))
                    assert tt._price(kind, sig, thw, c, resident) == \
                        jt._price(kind, sig, jhw, jc, resident), (kind, c)
                for measured in (False, True):
                    assert tat.cache_key(kind, sig, backend, thw, fixed,
                                         resident, measured) == \
                        jat.cache_key(kind, sig, backend, jhw,
                                      None if fixed is None else jfixed,
                                      resident, measured)
                assert _dec(tt._search(kind, sig, thw, resident, None)) == \
                    _dec(jt._search(kind, sig, jhw, resident, None))
    assert n_sigs > 0
    assert tt.stats == jt.stats


def test_full_width_cnet_picks_the_channel_blocked_stem():
    """At cnet_plus_scalar's published width the stem's whole-Cout output
    tile does not fit the accel analog's on-chip budget, so every rung
    tunes act0's conv to channel blocks of 16 (the grid the port's
    channel-blocked CUDA kernel runs)."""
    plan = _stub_plan(tcnet.build_graph(), "accel")
    hw = tenergy.BACKEND_HW["accel"]
    tuner = tat.Autotuner()
    for rung in (1, 16, 32):
        kind, sig = tat.node_spec(plan, "conv0", rung)
        dec = tuner._search(kind, sig, hw, False, None)
        assert dec.config.cout_per_block == 16
        assert dec.config.rows_per_block == 256
        t, _, feasible = tat.price_int8_conv(hw, *sig[:-2], sig[-2],
                                             sig[-1], 256, 0, False)
        assert not feasible


def test_cache_key_sensitive_to_shape_backend_and_hw():
    hw_a, hw_f = tenergy.BACKEND_HW["accel"], tenergy.BACKEND_HW["flex"]
    k0 = tat.cache_key("int8_dense", (4, 64, 16), "accel", hw_a)
    assert k0 == tat.cache_key("int8_dense", (4, 64, 16), "accel", hw_a)
    assert len(k0) == 20 and int(k0, 16) >= 0
    others = [
        tat.cache_key("int8_dense", (8, 64, 16), "accel", hw_a),
        tat.cache_key("int8_dense", (4, 64, 16), "flex", hw_f),
        tat.cache_key("int8_dense", (4, 64, 16), "accel", hw_a,
                      fixed=tat.KernelConfig(bn=16, bk=64)),
        tat.cache_key("int8_dense", (4, 64, 16), "accel", hw_a,
                      resident=False),
        tat.cache_key("int8_dense", (4, 64, 16), "accel", hw_a,
                      measured=True)]
    assert k0 not in others and len(set(others)) == len(others)


def test_kernel_config_round_trip():
    for c in (tat.KernelConfig(), tat.KernelConfig(8, 16, 32),
              tat.KernelConfig(rows_per_block=4, cout_per_block=8),
              tat.KernelConfig(bq=64, bk=128), tat.KernelConfig(chunk=64)):
        assert tat.KernelConfig.from_dict(c.to_dict()) == c
        assert c.to_dict() == jat.KernelConfig(
            **dataclasses.asdict(c)).to_dict()


def test_measured_refinement_on_the_cpu():
    """On the CPU the plain versions honour no tile setting, so the opt-in
    measured refinement has no differing launch to time: the model's pick
    stands, as without it, and nothing is measured."""
    hw = tenergy.BACKEND_HW["accel"]
    for kind, sig in (("int8_dense", (4, 64, 16)),
                      ("int8_conv", (2, 9, 7, 3, 3, 3, 12, 1, "SAME"))):
        tuner = tat.Autotuner(tat.TuningCache(None), measure=True,
                              measure_top_k=3, measure_repeats=1,
                              device="cpu")
        dec = tuner._search(kind, sig, hw, True, None)
        want = tat.Autotuner()._search(kind, sig, hw, True, None)
        assert dec == want and dec.source == "model"
        assert tuner.stats["measured"] == 0


def test_measured_refinement_needs_a_device():
    """Without a card the measured refinement raises unless the CPU is
    asked for, like every entry point of the port; pricing alone needs no
    device."""
    assert tat.Autotuner().device is None
    assert tat.Autotuner(measure=True, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tat.Autotuner(measure=True)


def test_launch_key_groups_candidates_by_what_the_kernel_runs():
    """On the card only the conv's channel blocking changes the launch
    (the matmul tile and the conv row tile are fixed); on the CPU no
    setting does. Candidates with one key are timed once."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    convs = tat.conv_candidates(256, 48)
    keys = {tat.launch_key("int8_conv", c, cuda) for c in convs}
    assert keys == {c.cout_per_block for c in convs} and len(keys) > 1
    assert {tat.launch_key("int8_conv", c, cpu) for c in convs} == {None}
    for dev in (cuda, cpu):
        assert {tat.launch_key("int8_dense", c, dev)
                for c in tat.dense_candidates(16, 32769, 92)} == {None}


# ---------------------------------------------------------------------------
# the kernel variants, bit-exact against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, "VALID")])
def test_conv2d_int8_bit_exact_across_tile_configs(stride, padding):
    """Every conv_candidates config of a 9x7x3 -> 12 conv: the reference
    runs its channel-blocked grid for cout_per_block 8."""
    rng = np.random.default_rng(2)
    h, wd, cin, cout, kk = 9, 7, 3, 12, 3
    x = rng.integers(-127, 128, (2, h, wd, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (kk, kk, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.01, 1, cout).astype(np.float32)
    b = rng.uniform(-1, 1, cout).astype(np.float32)
    kw = dict(x_scale=0.5, stride=stride, padding=padding, act="relu",
              requant_scale=0.37)
    h_out = tconv.conv_geometry(h, wd, kk, kk, stride, padding, 1).h_out
    cands = tat.conv_candidates(h_out, cout)
    assert any(c.cout_per_block for c in cands)
    for cfg in cands:
        tiles = dict(rows_per_block=cfg.rows_per_block or 8,
                     cout_per_block=cfg.cout_per_block)
        want = np.asarray(jops.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws), jnp.asarray(b),
            **kw, **tiles))
        got = tops.conv2d_int8(_t(x), _t(w), _t(ws), _t(b), **kw, **tiles)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cfg))


def test_conv2d_int8_prepacked_prepadded_bit_exact():
    """Channel-padded weights (neutral scale/bias on the pad channels) on
    an input staged at plan time by conv_geometry/pad_input."""
    rng = np.random.default_rng(3)
    h, wd, cin, cout, kk = 10, 10, 4, 9, 3
    x = rng.integers(-127, 128, (2, h, wd, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (kk, kk, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.01, 1, cout).astype(np.float32)
    b = rng.uniform(-1, 1, cout).astype(np.float32)
    rows, bc = 3, 8
    pad_c = -(-cout // bc) * bc - cout
    g = tconv.conv_geometry(h, wd, kk, kk, 2, "SAME", rows)
    xp = tconv.pad_input(_t(x), g)
    wp = torch.nn.functional.pad(_t(w), (0, pad_c))
    wsp, bp = pad_channel_params(_t(ws), _t(b), pad_c)
    kw = dict(x_scale=0.5, stride=2, requant_scale=0.11)
    got = tops.conv2d_int8(xp, wp, wsp, bp, rows_per_block=rows,
                           cout_per_block=bc, cout=cout, pre_padded=True,
                           in_hw=(h, wd), **kw)
    want = np.asarray(jops.conv2d_int8(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(ws), jnp.asarray(b),
                                       **kw))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the reference's own prepacked call gives the same codes
    jg = jnp.pad(jnp.asarray(x), ((0, 0), (g.pad_top, g.pad_bottom),
                                  (g.pad_left, g.pad_right), (0, 0)))
    jwant = np.asarray(jops.conv2d_int8(
        jg, jnp.asarray(wp.numpy()), jnp.asarray(wsp.numpy()),
        jnp.asarray(bp.numpy()), rows_per_block=rows, cout_per_block=bc,
        cout=cout, pre_padded=True, in_hw=(h, wd), **kw))
    np.testing.assert_array_equal(got.numpy(), jwant)


def test_conv2d_int8_pre_padded_checks_the_geometry():
    x = torch.zeros((1, 10, 10, 4), dtype=torch.int8)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="in_hw"):
        tops.conv2d_int8(x, w, torch.ones(8), pre_padded=True)
    with pytest.raises(ValueError, match="does not match geometry"):
        tops.conv2d_int8(x, w, torch.ones(8), pre_padded=True,
                         in_hw=(10, 10))
    with pytest.raises(ValueError):
        tops.conv2d_int8(x, w, torch.ones(8), cout=9)


@pytest.mark.parametrize("requant", [None, 0.37])
def test_int8_matmul_prepacked_bit_exact(requant):
    rng = np.random.default_rng(1)
    m, k, n = 4, 50, 10
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = rng.uniform(0.01, 1, m).astype(np.float32)
    ws = rng.uniform(0.01, 1, n).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    want = np.asarray(jops.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ws),
        jnp.asarray(b), act="relu", requant_scale=requant))
    for bk, bn in ((8, 8), (64, 16), (128, 128)):
        kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
        wp = np.pad(w, ((0, kp - k), (0, np_ - n)))
        wsp = np.pad(ws, (0, np_ - n), constant_values=1.0)
        bp = np.pad(b, (0, np_ - n))
        jgot = np.asarray(jops.int8_matmul(
            jnp.asarray(x), jnp.asarray(wp), jnp.asarray(xs),
            jnp.asarray(wsp), jnp.asarray(bp), act="relu",
            requant_scale=requant, bm=8, bn=bn, bk=bk, prepacked=True,
            n_out=n))
        got = tops.int8_matmul(_t(x), _t(wp), _t(xs), _t(wsp), _t(bp),
                               act="relu", requant_scale=requant, bm=8,
                               bn=bn, bk=bk, prepacked=True, n_out=n)
        assert got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), jgot)


def test_int8_matmul_prepacked_checks_the_layout():
    x = torch.zeros((4, 70), dtype=torch.int8)
    wp = torch.zeros((128, 16), dtype=torch.int8)
    ones = torch.ones(16)
    with pytest.raises(ValueError, match="prepacked"):       # bn
        tops.int8_matmul(x, wp, torch.ones(4), ones, bn=32, bk=128,
                         prepacked=True, n_out=13)
    with pytest.raises(ValueError, match="prepacked"):       # k > kp
        tops.int8_matmul(torch.zeros((4, 130), dtype=torch.int8), wp,
                         torch.ones(4), ones, bn=16, bk=128, prepacked=True)
    with pytest.raises(ValueError, match="prepacked"):       # n_out > np
        tops.int8_matmul(x, wp, torch.ones(4), ones, bn=16, bk=128,
                         prepacked=True, n_out=17)
    out = tops.int8_matmul(x, wp, torch.ones(4), ones, bn=16, bk=128,
                           prepacked=True, n_out=13)
    assert out.shape == (4, 13)


def test_cpu_variants_count_no_launch():
    tops.reset_launch_counts()
    x = torch.zeros((1, 9, 7, 3), dtype=torch.int8)
    tops.conv2d_int8(x, torch.zeros((3, 3, 3, 12), dtype=torch.int8),
                     torch.ones(12), cout_per_block=8)
    assert set(tops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the tuning cache
# ---------------------------------------------------------------------------


def _narrow_engine(**kw):
    e = TEngine(tcnet.build_graph(**NARROW), tcnet.init_params(1, **NARROW),
                device="cpu", **kw)
    rng = np.random.default_rng(1)
    e.calibrate([tcnet.synthetic_input(rng, NARROW["input_shape"])
                 for _ in range(2)])
    return e


def _tuned_configs(engine, rungs=(1, 4)):
    for r in rungs:
        engine.compile("accel", r)
    plan = engine.planned("accel")
    return {r: {n: d.config for n, d in dec.items()}
            for r, dec in plan._tuning.items()}


def test_cache_roundtrip_same_graph_same_picks(tmp_path):
    path = str(tmp_path / "tuning.json")
    e1 = _narrow_engine(autotune=True, tuning_cache=path)
    picks1 = _tuned_configs(e1)
    assert e1.tuner.stats["evaluated"] > 0 and len(e1.tuner.cache) > 0
    payload = json.loads((tmp_path / "tuning.json").read_text())
    assert payload["version"] == tat.SCHEMA_VERSION
    # a new engine over the warm file: the same picks, no evaluation
    e2 = _narrow_engine(autotune=True, tuning_cache=path)
    assert _tuned_configs(e2) == picks1
    assert e2.tuner.stats["evaluated"] == 0
    assert e2.tuner.stats["cache_hits"] == e2.tuner.stats["nodes"] > 0
    sources = {d.source for dec in e2.planned("accel")._tuning.values()
               for d in dec.values()}
    assert sources == {"cache"}


def test_second_lower_same_engine_no_research():
    e = _narrow_engine(autotune=True)
    e.compile("accel", 4)
    evaluated = e.tuner.stats["evaluated"]
    n0 = e.planned("accel").n_traces
    e.compile("accel", 4)
    assert e.tuner.stats["evaluated"] == evaluated
    assert e.planned("accel").n_traces == n0


def test_stale_cache_schema_discarded(tmp_path, capsys):
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"version": -1, "entries": {"x": {}}}))
    assert len(tat.TuningCache(str(path))) == 0
    assert "stale" in capsys.readouterr().out


def test_corrupt_cache_file_is_cold_not_fatal(tmp_path, capsys):
    for blob in ('{"version": 1, "entries": {"trunc', "\x00\x7fELF garbage",
                 "[1, 2, 3]", '"just a string"'):
        path = tmp_path / "tuning.json"
        path.write_text(blob)
        assert len(tat.TuningCache(str(path))) == 0
        out = capsys.readouterr().out
        assert "ignoring" in out and "cold cache" in out
    assert len(tat.TuningCache(str(tmp_path))) == 0      # a directory
    assert "cold cache" in capsys.readouterr().out


def test_corrupt_cache_recovers_end_to_end(tmp_path):
    path = tmp_path / "tuning.json"
    path.write_text('{"version": 1, "entries"')           # a torn write
    e = _narrow_engine(autotune=True, tuning_cache=str(path))
    e.compile("accel", 4)                                 # tunes + saves
    payload = json.loads(path.read_text())
    assert payload["version"] == tat.SCHEMA_VERSION
    assert isinstance(payload["entries"], dict) and payload["entries"]


def test_engine_refuses_cache_options_without_autotune():
    g = tcnet.build_graph(**NARROW)
    with pytest.raises(ValueError, match="autotune=True"):
        TEngine(g, tcnet.init_params(1, **NARROW), device="cpu",
                tuning_cache="x.json")
    with pytest.raises(ValueError, match="autotune=True"):
        TEngine(g, tcnet.init_params(1, **NARROW), device="cpu",
                autotune_measure=True)
    assert TEngine(g, tcnet.init_params(1, **NARROW),
                   device="cpu").tuner is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["space", "lm"])
@pytest.mark.parametrize("flag", [["--tuning-cache", "t.json"],
                                  ["--autotune-measure"]])
def test_launcher_cache_flags_need_autotune(mode, flag):
    args = serve.parser().parse_args(["--mode", mode, "--device", "cpu",
                                      "--backend", "accel", *flag])
    build = serve.build_scheduler if mode == "space" \
        else serve.build_lm_scheduler
    with pytest.raises(SystemExit, match="--autotune"):
        build(args)


def test_launcher_serves_autotuned_cnet_with_a_warm_cache(tmp_path, capsys):
    """The slice's command with --autotune at full width on the CPU plain
    versions; a second build over the saved cache searches nothing."""
    path = str(tmp_path / "tuning.json")
    argv = ["--mode", "space", "--model", "cnet_plus_scalar", "--backend",
            "accel", "--requests", "3", "--batch", "2", "--device", "cpu",
            "--autotune", "--tuning-cache", path]
    assert serve.main(argv) == 0
    assert "3/3 served" in capsys.readouterr().out
    entries = json.loads(open(path).read())["entries"]
    assert any(e["config"].get("cout_per_block") == 16
               for e in entries.values())
    _, _, engines = serve.build_scheduler(serve.parser().parse_args(argv))
    stats = engines["cnet_plus_scalar"].tuner.stats
    assert stats["evaluated"] == 0 and stats["cache_hits"] == stats["nodes"]


def test_launcher_serves_the_autotuned_lm_on_the_cpu(capsys):
    assert serve.main(["--mode", "lm", "--backend", "accel", "--device",
                       "cpu", "--requests", "2", "--tokens", "2",
                       "--autotune"]) == 0
    assert "[lm] sample continuation" in capsys.readouterr().out
