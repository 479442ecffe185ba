"""The LM slice end to end against the JAX reference, at the reference's
small ``DEFAULT_CONFIG`` (d_model 32, seq_len 32).

Parameters are drawn on the JAX side and carried over as numpy arrays;
calibration is either carried too or computed by the port on the same
samples. Both engines serve the same prompts, with these tolerances:

* accel prefill K/V cache codes and f16 scales: bit-exact (the K/V
  projections are exact int8 products and the quantizer repeats the
  reference's roundings);
* accel logits and hidden: within ``ACCEL_ATOL`` = 1e-5. The per-position
  projections are exact; attention and the SSD scan are fp32 with other
  summation orders (measured here: within 5e-7). An int8 code can move by
  one where attention's output sits at a .5 boundary of the next layer's
  activation quantizer, which this tolerance would catch;
* flex logits and hidden: within 1e-4;
* the SSD cache state: within 1e-4;
* tokens: equal wherever the reference's top-2 logit margin exceeds twice
  the tolerance.

Decode is compared step by step from the same feedback features (the
reference's), so a difference cannot compound through the feedback loop.
"""
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.engine import Engine as JEngine
from repro.core.lm import LMEngine as JLMEngine
from repro.core.scheduler import LMRequest as JRequest
from repro.core.scheduler import LMScheduler as JScheduler
from repro.models import lm as jlm
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.lm import LMEngine as TLMEngine
from repro_torch.core.scheduler import LMRequest, LMScheduler
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from test_torch_support import graph_signature, to_numpy_params

ROOT = Path(__file__).resolve().parents[1]
CFG = tlm.DEFAULT_CONFIG
ACCEL_ATOL = 1e-5
FLEX_ATOL = 1e-4
N_SLOTS = 3


@pytest.fixture(scope="module")
def engines():
    """JAX engine + two port engines on the JAX-drawn parameters: one
    adopting the reference's calibration, one calibrating itself on the
    same 4 windows."""
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.DEFAULT_CONFIG)
    params = to_numpy_params(jp)
    rng = np.random.default_rng(1)
    calib = [tlm.synthetic_input(rng, CFG) for _ in range(4)]
    je = JEngine(jlm.build_graph(jlm.DEFAULT_CONFIG), jp)
    je.calibrate(calib)
    te = TEngine(tlm.build_graph(CFG), params_from_numpy(params, "cpu"),
                 device="cpu")
    te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                               "cpu"))
    own = TEngine(tlm.build_graph(CFG), params_from_numpy(params, "cpu"),
                  device="cpu")
    own.calibrate(calib)
    return je, te, own


def _prompts(n, seed=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, CFG.seq_len, CFG.d_model)
                      ).astype(np.float32) * 0.5


def _tokens_agree(got, want_tokens, logits, tol):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * tol
    np.testing.assert_array_equal(got[sure], want_tokens[sure])


def test_graph_and_params_mirror_the_reference():
    for cfg in (CFG, tlm.ZAMBA2_1_2B):
        jcfg = jlm.LMConfig(*cfg)
        assert (graph_signature(tlm.build_graph(cfg))
                == graph_signature(jlm.build_graph(jcfg)))
    tp = tlm.init_params(0, CFG)
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.DEFAULT_CONFIG)
    assert {n: {k: tuple(v.shape) for k, v in p.items()}
            for n, p in tp.items()} == \
        {n: {k: tuple(v.shape) for k, v in p.items()} for n, p in jp.items()}
    a = tp["ssm"]["A"]
    assert a.dtype == torch.float32 and bool(((a >= -1.5) & (a <= -0.5)).all())
    assert tlm.CAPTURE_OUTPUTS == jlm.CAPTURE_OUTPUTS
    assert tlm.SERVE_OUTPUTS == jlm.SERVE_OUTPUTS
    x = tlm.synthetic_batch(np.random.default_rng(0), 3, CFG)["x"]
    assert x.shape == (3, CFG.seq_len, CFG.d_model) and x.dtype == np.float32


def test_zamba2_widths():
    """The wide block: zamba2-1.2b's widths, about 104 M parameters."""
    g = tlm.build_graph(tlm.ZAMBA2_1_2B)
    assert g.nodes["q_heads"].out_shape == (2048, 32, 64)
    assert g.nodes["ssm_heads"].out_shape == (2048, 64, 64)
    assert g.nodes["head"].out_shape == (2048, 32000)
    assert 103_000_000 < g.n_params < 105_000_000


def test_port_calibration_matches_reference(engines):
    je, _, own = engines
    assert set(own._calib) == set(je._calib)
    for name, v in je._calib.items():
        assert own._calib[name] == pytest.approx(v, rel=1e-5), name
    assert own.planned("accel").demoted == je.planned("accel").demoted
    for name, q in je._quant.items():
        np.testing.assert_array_equal(own._quant[name].w_q.numpy(),
                                      np.asarray(q.w_q))
    x = _prompts(3)
    got = own.run_batch({"x": x}, "accel")
    want = je.run_batch({"x": jnp.asarray(x)}, "accel")
    for name in ("head", "resid2"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=ACCEL_ATOL, atol=ACCEL_ATOL)


@pytest.mark.parametrize("backend", ["accel", "flex"])
def test_plan_and_kv_plan_mirror_the_reference(engines, backend):
    je, te, _ = engines
    jl = JLMEngine(je, backend=backend, n_slots=N_SLOTS, max_new_tokens=8)
    tl = TLMEngine(te, backend=backend, n_slots=N_SLOTS, max_new_tokens=8)
    assert tl.plan.as_text() == jl.plan.as_text()
    assert "kv[" in tl.plan.summary()
    assert tl.capacity == jl.capacity and tl.capacity % 128 == 0
    sig_t, sig_j = tl.plan.cost_signature(2), jl.plan.cost_signature(2)
    assert sig_t.kv_resident_bytes == sig_j.kv_resident_bytes > 0
    assert asdict(sig_t) == asdict(sig_j)


@pytest.mark.parametrize("backend,atol", [("accel", ACCEL_ATOL),
                                          ("flex", FLEX_ATOL)])
def test_prefill_and_decode_match_reference(engines, backend, atol):
    je, te, _ = engines
    jl = JLMEngine(je, backend=backend, n_slots=N_SLOTS, max_new_tokens=8)
    tl = TLMEngine(te, backend=backend, n_slots=N_SLOTS, max_new_tokens=8)
    x = _prompts(3)
    slots = np.array([0, 2, N_SLOTS], np.int32)      # last lane: padding
    jr, tr = jl.prefill(x, slots), tl.prefill(x, slots)

    jo = je.run_batch({"x": jnp.asarray(x)}, backend)
    to = te.run_batch({"x": x}, backend)
    for name in ("head", "resid2"):
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]),
                                   rtol=atol, atol=atol)
    _tokens_agree(tr.tokens, jr.tokens, np.asarray(jo["head"])[:, -1], atol)
    np.testing.assert_allclose(tr.hidden, jr.hidden, rtol=atol, atol=atol)

    real = slots[:2]
    for w in ("k_codes", "k_scale", "v_codes", "v_scale"):
        got = tl.caches["attn"][w].numpy()[real]
        want = np.asarray(jl.caches["attn"][w])[real]
        if backend == "accel":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got.astype(np.float32),
                                       want.astype(np.float32), atol=1.0)
    np.testing.assert_array_equal(tl.caches["pos"].numpy()[real],
                                  np.asarray(jl.caches["pos"])[real])
    np.testing.assert_allclose(tl.caches["ssm"]["state"].numpy()[real],
                               np.asarray(jl.caches["ssm"]["state"])[real],
                               rtol=1e-4, atol=1e-4)

    hidden = jr.hidden
    for _ in range(3):
        jr = jl.decode_step(hidden, slots)
        tr = tl.decode_step(hidden, slots)
        np.testing.assert_allclose(tr.hidden[:2], jr.hidden[:2], rtol=atol,
                                   atol=atol)
        np.testing.assert_array_equal(tr.tokens[:2], jr.tokens[:2])
        hidden = jr.hidden
    np.testing.assert_allclose(tl.caches["ssm"]["state"].numpy()[real],
                               np.asarray(jl.caches["ssm"]["state"])[real],
                               rtol=1e-4, atol=1e-4)


def test_prefill_cache_codes_match_direct_quantize(engines):
    from repro_torch.core import lm_quant
    _, te, _ = engines
    lm = TLMEngine(te, backend="accel", n_slots=2, max_new_tokens=4)
    x = _prompts(2, seed=12)
    slots = np.array([lm.assign_slot("c"), lm.assign_slot("d")], np.int32)
    lm.prefill(x, slots)
    codes, scale = lm_quant.quantize_kv(te.run_batch({"x": x},
                                                     "accel")["k_heads"])
    got = lm.caches["attn"]["k_codes"][slots, :CFG.seq_len]
    assert torch.equal(got, codes)
    got_s = lm.caches["attn"]["k_scale"][slots, :CFG.seq_len]
    assert torch.equal(got_s, scale.to(torch.float16))
    assert bool((lm.caches["attn"]["k_scale"][slots, CFG.seq_len:]
                 == 1.0).all())
    assert lm.release_slot("c") == slots[0]
    assert lm.release_slot("d") == slots[1]


def test_prefill_decode_steady_state_counters(engines):
    _, te, _ = engines
    lm = TLMEngine(te, backend="accel", n_slots=3, max_new_tokens=8)
    x = _prompts(2)
    slots = np.array([lm.assign_slot("a"), lm.assign_slot("b")], np.int32)
    res = lm.prefill(x, slots)
    assert res.tokens.shape == (2,) and res.tokens.dtype == np.int32
    assert res.hidden.shape == (2, CFG.d_model)
    res = lm.decode_step(res.hidden, slots)          # warm the rung
    traces0, assigns0 = lm.n_traces, lm.slots.n_assigns
    for _ in range(4):
        res = lm.decode_step(res.hidden, slots)
        assert np.isfinite(res.hidden).all()
        assert ((0 <= res.tokens) & (res.tokens < CFG.vocab)).all()
    assert lm.n_traces == traces0                    # nothing rebuilt
    assert lm.slots.n_assigns == assigns0            # no slot allocated
    assert lm.release_slot("a") == slots[0]
    assert lm.release_slot("b") == slots[1]


def test_scheduler_serves_stream_like_the_reference(engines):
    """The same stream through both schedulers: every request completes
    with the reference's tokens, every slot is released, and the
    dispatch counts agree."""
    je, te, _ = engines
    jl = JLMEngine(je, backend="accel", n_slots=N_SLOTS, max_new_tokens=8)
    tl = TLMEngine(te, backend="accel", n_slots=N_SLOTS, max_new_tokens=8)
    js, ts = JScheduler(jl), LMScheduler(tl)
    j0, t0 = jl.n_traces, tl.n_traces        # the plans are shared
    for rid in range(5):
        x = _prompts(1, seed=rid)[0]
        js.submit(JRequest(rid=rid, x=x, max_new_tokens=3,
                           deadline_s=1e9))
        ts.submit(LMRequest(rid=rid, x=x, max_new_tokens=3,
                            deadline_s=1e9))
    jc, tc = js.run(), ts.run()
    assert sorted(c.rid for c in tc) == list(range(5))
    assert all(len(c.tokens) == 3 for c in tc)
    assert {c.rid: c.tokens for c in tc} == {c.rid: c.tokens for c in jc}
    assert tl.slots.in_use == 0
    tel, jtel = ts.telemetry(), js.telemetry()
    assert tel.n_completed == 5 and tel.n_tokens == 15
    for f in ("n_prefill_dispatches", "n_decode_dispatches",
              "n_slot_assigns", "slot_high_water"):
        assert getattr(tel, f) == getattr(jtel, f), f
    assert tel.n_traces - t0 == jtel.n_traces - j0
    per_rid = {}
    for ev in ts.events:
        per_rid.setdefault(ev.rid, []).append(ev.index)
    assert all(idx == list(range(3)) for idx in per_rid.values())
    assert "5/5 served" in ts.summary()


def test_scheduler_validates_requests(engines):
    _, te, _ = engines
    sched = LMScheduler(TLMEngine(te, backend="accel", n_slots=2,
                                  max_new_tokens=8))
    with pytest.raises(ValueError, match="prompt window"):
        sched.submit(LMRequest(rid=0, x=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="decode budget"):
        sched.submit(LMRequest(rid=1, x=_prompts(1)[0],
                               max_new_tokens=10 ** 6))
    with pytest.raises(ValueError, match="exceeds"):
        LMScheduler(sched.lm, prefill_ladder=(1, 4))


def test_lm_engine_requires_fuse():
    e = TEngine(tlm.build_graph(CFG), tlm.init_params(0, CFG), fuse=False,
                device="cpu")
    with pytest.raises(ValueError, match="fuse=True"):
        TLMEngine(e, backend="flex")


def test_launcher_serves_the_lm_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--device", "cpu", "--requests", "4", "--tokens", "3"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "4/4 served" in out.stdout and "kv[lm_decoder]" in out.stdout


def test_launcher_lm_accel_on_the_cpu(capsys):
    assert serve.main(["--mode", "lm", "--backend", "accel", "--device",
                       "cpu", "--requests", "3", "--tokens", "2",
                       "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3/3 served" in out and "11 quantized node(s)" in out
