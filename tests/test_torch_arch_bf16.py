"""The large-model stack as served, in bf16, against the live JAX
reference: the ``reduced()`` config of every family (as in
``test_torch_arch_fp32.py``), the reference's bf16 params carried over as
numpy, its steps through ``jax.jit``.

Bounds: logits (train mode, prefill, 4 decode steps) within 2e-2 of
max|logits|, the LM slice's bf16 bound; greedy tokens equal wherever the
reference's top-2 margin exceeds 4e-2. The port rounds where the
reference's compiled program rounds, also where XLA drops a rounding the
source writes (``nn/layers.py``); what remains is bf16 rounding noise
between the two libraries, which grows with depth (the hybrid's most).

Under the int8 KV cache, the bf16 K/V may themselves differ by an ulp or
more: the codes are the reference's quantizer of the port's own K/V, bit
for bit, and equal the reference's codes on every (batch, position, head)
row whose K/V equal the reference's.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.lm_quant import quantize_kv as j_quantize_kv
from repro.launch import steps as j_steps
from repro_torch.launch import steps as t_steps
from test_torch_support import (ARCH_B, ARCH_CASES, ARCH_S, arch_inputs,
                                arch_run_both, arch_twin_cfgs,
                                arch_twin_params, as_f32, logit_errors)

TOL = 2e-2
MARGIN = 4e-2


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_logits_and_greedy_tokens_match_reference(case, impl):
    out = arch_run_both(case, "bf16", impl)
    errs = logit_errors(out)
    assert max(errs) <= TOL, errs
    j, t = out["jax"], out["torch"]
    for want, got in zip([j["prefill"]] + j["decode"],
                         [t["prefill"]] + t["decode"]):
        assert got.dtype == torch.bfloat16
        w, g = as_f32(want), as_f32(got)
        top2 = np.sort(w, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > MARGIN
        np.testing.assert_array_equal(g.argmax(-1)[sure], w.argmax(-1)[sure])


def _prefill_kv(case, kv_quant):
    """Both packages' bf16 prefill attention caches (of the attention
    blocks: the hybrid's shared block, else every layer)."""
    jc, jd, tc, td = arch_twin_cfgs(case, kv_quant)
    jp, tp = arch_twin_params(jc, jd, "bf16")
    jb, tb = arch_inputs(jc, jd, ARCH_B, ARCH_S, "bf16")
    _, jcache = jax.jit(j_steps.make_prefill_step(jc, jd))(jp, jb)
    _, tcache = t_steps.make_prefill_step(tc, td)(tp, tb)
    return (jcache["groups"].get("attn", jcache["groups"]),
            tcache["groups"].get("attn", tcache["groups"]))


@pytest.mark.parametrize("case", ["dense", "hybrid_tail"])
def test_int8_kv_codes_follow_the_bf16_kv(case):
    j_kv, t_kv = _prefill_kv(case, False)
    j_q, t_q = _prefill_kv(case, True)
    n_equal = 0
    for name in ("k", "v"):
        k_t, k_j = as_f32(t_kv[name]), as_f32(j_kv[name])
        codes, scales = jax.jit(j_quantize_kv)(
            jnp.asarray(k_t).astype(jnp.bfloat16))
        np.testing.assert_array_equal(t_q[f"{name}_q"].numpy(),
                                      np.asarray(codes))
        np.testing.assert_array_equal(t_q[f"{name}_s"].numpy(),
                                      np.asarray(scales))
        same = np.all(k_t == k_j, axis=-1)
        n_equal += int(same.sum())
        np.testing.assert_array_equal(t_q[f"{name}_q"].numpy()[same],
                                      np.asarray(j_q[f"{name}_q"])[same])
    assert n_equal > 0


@pytest.mark.parametrize("case", ["dense", "hybrid_tail"])
def test_int8_kv_serving_holds_the_bf16_bound(case):
    out = arch_run_both(case, "bf16", "chunked", kv_quant=True)
    assert max(logit_errors(out)) <= TOL
