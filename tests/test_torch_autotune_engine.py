"""Autotuned engines of the port against the JAX reference's autotuned
engines, on the narrow CNet-shaped graph (32x32x2, channels 8/8/4, dense
12), a wide-stem twin (256x256x2 -> 48/8/4) and the LM block at the
reference's ``DEFAULT_CONFIG``.

Parameters are drawn on the JAX side and carried as numpy arrays, and the
reference's calibration is carried too. Tolerances:

* tuning decisions, ``as_text()`` (with its autotune lines) and the tuned
  cost signatures: identical (the same pricers on the same numbers);
* CNet accel outputs: bit-exact, tuned port vs untuned port vs tuned
  reference (integer sums; padding lanes are exact zeros);
* the LM: the tolerances of tests/test_torch_lm.py (accel logits and
  hidden within 1e-5, K/V cache codes and scales bit-exact, the SSD state
  within 1e-4, tokens equal where the reference's top-2 margin exceeds
  twice the tolerance).
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import autotune as jat
from repro.core.engine import Engine as JEngine
from repro.core.lm import LMEngine as JLMEngine
from repro.models import lm as jlm
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core import autotune as tat
from repro_torch.core import energy as tenergy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.lm import LMEngine as TLMEngine
from repro_torch.models import cnet_plus_scalar as tcnet
from repro_torch.models import lm as tlm
from test_torch_support import NARROW, to_numpy_params, twin_engines

WIDE_STEM = dict(input_shape=(256, 256, 2), channels=(48, 8, 4), dense=12)
RUNGS = (1, 4)
LM_ATOL = 1e-5


def _decisions(plan):
    return {r: {n: (d.kind, d.config.to_dict(), d.modeled_s, d.default_s,
                    d.extra_bytes)
                for n, d in dec.items()}
            for r, dec in plan._tuning.items()}


@pytest.fixture(scope="module")
def tuned():
    """(reference engine, port engine, untuned port engine, batch), the
    two tuned engines lowered at RUNGS on both backends."""
    je, te, _ = twin_engines(autotune=True)
    _, te0, _ = twin_engines()
    for e in (je, te):
        for backend in ("accel", "flex"):
            for r in RUNGS:
                e.compile(backend, r)
    batch = tcnet.synthetic_batch(np.random.default_rng(7), RUNGS[-1],
                                  NARROW["input_shape"])
    return je, te, te0, batch


@pytest.mark.parametrize("backend", ["accel", "flex"])
def test_tune_plan_decisions_equal_reference(tuned, backend):
    je, te, _, _ = tuned
    jp, tp = je.planned(backend), te.planned(backend)
    assert _decisions(tp) == _decisions(jp)
    assert sorted(tp._tuning) == sorted(jp._tuning)
    if backend == "accel":
        assert sorted(tp._tuning) == sorted(set(RUNGS) | {tp.pack_batch})
        assert {n: c.to_dict() for n, c in tp._layouts.items()} == \
            {n: c.to_dict() for n, c in jp._layouts.items()}
        assert tp._packed_bytes == jp._packed_bytes
    assert te.tuner.stats == je.tuner.stats


def test_packed_arena_equals_reference(tuned):
    je, te, _, _ = tuned
    jp, tp = je.planned("accel"), te.planned("accel")
    assert set(tp.packed) == set(jp.packed) == set(tp.qplans)
    for name, pk in tp.packed.items():
        jpk = jp.packed[name]
        np.testing.assert_array_equal(pk.w_q.numpy(), np.asarray(jpk.w_q))
        np.testing.assert_array_equal(pk.w_scale.numpy(),
                                      np.asarray(jpk.w_scale))
        if pk.bias is not None:
            np.testing.assert_array_equal(pk.bias.numpy(),
                                          np.asarray(jpk.bias))
        assert tp.weight_arena[name] is pk.w_q
    hw = tenergy.BACKEND_HW["accel"]
    packed = tenergy.weight_bytes(tp.graph, "accel", set(tp.qplans),
                                  tp._packed_bytes)
    assert tp.arena.weight_bytes == packed
    assert tp.arena.bram_budget == int(hw.onchip_bytes) - packed


def test_tuned_outputs_bit_exact_to_untuned_and_reference(tuned):
    je, te, te0, batch = tuned
    for r in RUNGS:
        sub = {k: v[:r] for k, v in batch.items()}
        got = te.run_batch(sub, "accel")
        untuned = te0.run_batch(sub, "accel")
        want = je.run_batch({k: jnp.asarray(v) for k, v in sub.items()},
                            "accel")
        for k in got:
            assert got[k].dtype == untuned[k].dtype
            assert torch.equal(got[k], untuned[k]), (r, k)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        # flex: the hls configs price only, execution is unchanged
        assert torch.equal(te.run_batch(sub, "flex")["head"],
                           te0.run_batch(sub, "flex")["head"])


@pytest.mark.parametrize("backend", ["accel", "flex"])
def test_as_text_and_tuned_cost_signatures_equal_reference(tuned, backend):
    je, te, _, _ = tuned
    jp, tp = je.planned(backend), te.planned(backend)
    text = tp.as_text()
    assert text == jp.as_text()
    assert "autotune @ batch" in text
    assert ("packed=" in text) == (backend == "accel")
    for r in RUNGS + (16,):
        for name in ("cost_signature", "default_cost_signature",
                     "pipelined_cost_signature"):
            assert dataclasses.asdict(getattr(tp, name)(r)) == \
                dataclasses.asdict(getattr(jp, name)(r)), (name, r)
        assert [dataclasses.asdict(s) for s in tp.stage_costs(r)] == \
            [dataclasses.asdict(s) for s in jp.stage_costs(r)]
        tuned_sig, default = tp.cost_signature(r), \
            tp.default_cost_signature(r)
        assert tuned_sig.latency_s <= default.latency_s * (1 + 1e-9)


def test_autotune_off_reproduces_the_untuned_plans(tuned):
    _, _, te0, _ = tuned
    off = TEngine(te0.graph, te0.params, device="cpu", autotune=False)
    off.share_calibration(te0)
    for backend in ("flex", "accel"):
        p0, p1 = te0.planned(backend), off.planned(backend)
        p0.lower(4)
        assert p0.tuner is None and not p0._tuning and not p0.packed
        assert p0.as_text() == p1.as_text()
        assert "autotune" not in p0.as_text()
        assert dataclasses.asdict(p0.cost_signature(8)) == \
            dataclasses.asdict(p1.cost_signature(8))


def test_wide_stem_twin_tunes_act0_to_channel_blocks():
    """The published stem (256x256x2 -> 48) on a narrow body: decisions
    equal the reference's at every rung, and act0 takes channel blocks of
    16 (its whole-Cout output tile does not fit the accel analog)."""
    je, te, _ = twin_engines(n_calib=1, widths=WIDE_STEM)
    jp, tp = je.planned("accel"), te.planned("accel")
    for r in (1, 16, 32):
        jd = jat.Autotuner().tune_plan(jp, r)
        td = tat.Autotuner().tune_plan(tp, r)
        assert {n: d.config.to_dict() for n, d in td.items()} == \
            {n: d.config.to_dict() for n, d in jd.items()}
        assert td["act0"].config.cout_per_block == 16
        assert td["act0"].config.rows_per_block == 256
        assert not td["act1"].config.cout_per_block
    # the port's tuned engine serves it bit-exact to its untuned twin
    tuned_e = TEngine(te.graph, te.params, device="cpu", autotune=True)
    tuned_e.share_calibration(te)
    batch = tcnet.synthetic_batch(np.random.default_rng(5), 2,
                                  WIDE_STEM["input_shape"])
    assert torch.equal(tuned_e.run_batch(batch, "accel")["head"],
                       te.run_batch(batch, "accel")["head"])
    assert tuned_e.planned("accel").packed["act0"].cout_per_block == 16


# ---------------------------------------------------------------------------
# the LM block, tuned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_engines():
    cfg = tlm.DEFAULT_CONFIG
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.DEFAULT_CONFIG)
    rng = np.random.default_rng(1)
    calib = [tlm.synthetic_input(rng, cfg) for _ in range(4)]
    je = JEngine(jlm.build_graph(jlm.DEFAULT_CONFIG), jp, autotune=True)
    je.calibrate(calib)
    carried = calibration_from_numpy(je._calib, je._ptq_err, "cpu")
    engines = []
    for autotune in (True, False):
        te = TEngine(tlm.build_graph(cfg),
                     params_from_numpy(to_numpy_params(jp), "cpu"),
                     device="cpu", autotune=autotune)
        te.load_calibration(carried)
        engines.append(te)
    return je, engines[0], engines[1]


def _prompts(n, seed=11):
    cfg = tlm.DEFAULT_CONFIG
    return np.random.default_rng(seed).normal(
        size=(n, cfg.seq_len, cfg.d_model)).astype(np.float32) * 0.5


def test_tuned_lm_matches_reference(lm_engines):
    je, te, te0 = lm_engines
    jl = JLMEngine(je, "accel", n_slots=3, max_new_tokens=6)
    tl = TLMEngine(te, "accel", n_slots=3, max_new_tokens=6)
    tl0 = TLMEngine(te0, "accel", n_slots=3, max_new_tokens=6)
    x = _prompts(3)
    slots = np.array([0, 2, 3], np.int32)             # last lane: padding
    jr, tr, tr0 = (e.prefill(x, slots) for e in (jl, tl, tl0))
    assert _decisions(tl.plan) == _decisions(jl.plan)
    kinds = {d[0] for dec in _decisions(tl.plan).values()
             for d in dec.values()}
    assert {"attention", "ssd", "int8_dense"} <= kinds
    assert tl.plan.packed and tl.plan.as_text() == jl.plan.as_text()
    np.testing.assert_allclose(tr.hidden, jr.hidden, rtol=LM_ATOL,
                               atol=LM_ATOL)
    np.testing.assert_array_equal(tr.tokens[:2], tr0.tokens[:2])
    real = slots[:2]
    for w in ("k_codes", "k_scale", "v_codes", "v_scale"):
        got = tl.caches["attn"][w].numpy()[real]
        np.testing.assert_array_equal(got,
                                      np.asarray(jl.caches["attn"][w])[real])
        np.testing.assert_array_equal(got, tl0.caches["attn"][w].numpy()[real])
    np.testing.assert_allclose(tl.caches["ssm"]["state"].numpy()[real],
                               np.asarray(jl.caches["ssm"]["state"])[real],
                               rtol=1e-4, atol=1e-4)
    hidden = jr.hidden
    for _ in range(3):
        jr, tr = jl.decode_step(hidden, slots), tl.decode_step(hidden, slots)
        np.testing.assert_allclose(tr.hidden[:2], jr.hidden[:2],
                                   rtol=LM_ATOL, atol=LM_ATOL)
        np.testing.assert_array_equal(tr.tokens[:2], jr.tokens[:2])
        hidden = jr.hidden


def test_tuned_lm_decode_reads_the_packed_arena(lm_engines):
    """Decode runs the quantized nodes on the packed buffers the prefill's
    lowering built (the arena holds them), equal to the untuned decode."""
    _, te, te0 = lm_engines
    tl = TLMEngine(te, "accel", n_slots=2, max_new_tokens=4)
    tl0 = TLMEngine(te0, "accel", n_slots=2, max_new_tokens=4)
    x = _prompts(2, seed=3)
    slots = np.array([0, 1], np.int32)
    r, r0 = tl.prefill(x, slots), tl0.prefill(x, slots)
    plan = tl.plan
    assert all(plan.weight_arena[n] is plan.packed[n].w_q
               for n in plan.qplans)
    assert any(plan.weight_arena[n].shape != plan.qplans[n].w_q.shape
               for n in plan.qplans)
    d, d0 = tl.decode_step(r.hidden, slots), tl0.decode_step(r0.hidden, slots)
    np.testing.assert_array_equal(d.hidden, d0.hidden)
    np.testing.assert_array_equal(d.tokens, d0.tokens)
