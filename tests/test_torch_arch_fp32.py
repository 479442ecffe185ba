"""The large-model stack's logic against the live JAX reference, in fp32:
the ``reduced()`` config of every family (dense GQA, ``qkv_bias``, MoE,
SSM, hybrid, an embedding front end, and a hybrid with a tail layer), the
reference's params (``init_params``, key 0) with every leaf cast to fp32
(its functions are dtype-generic) carried over as numpy, the same inputs
from a numpy seed, the reference's steps through ``jax.jit`` and its
Pallas flash kernel (``pallas``) in interpret mode
(``test_torch_support.arch_run_both``).

The ``train``-mode logits, the prefill logits and cache, and 4 decode
steps are within 1e-5 of max|logits| (the fp32 libraries sum in other
orders), for ``chunked`` and ``pallas``; under the int8 KV cache the codes
are bit-exact.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import numpy as np

from repro_torch.nn.params import tree_leaves
from test_torch_support import (ARCH_CASES, ATTENDING, arch_run_both,
                                as_f32, logit_errors)

TOL = 1e-5


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_logits_and_cache_match_reference(case, impl):
    out = arch_run_both(case, "f32", impl)
    errs = logit_errors(out)
    assert max(errs) <= TOL, errs
    scale = float(np.max(np.abs(as_f32(out["jax"]["prefill"]))))
    j, t = out["jax"]["cache"], out["torch"]["cache"]
    assert len(j) == len(t) > 0
    for got, want in zip(t, j):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("case", ATTENDING)
def test_int8_kv_codes_are_bit_exact(case):
    out = arch_run_both(case, "f32", "chunked", kv_quant=True)
    assert max(logit_errors(out)) <= TOL
    n_codes = 0
    for got, want in zip(tree_leaves(out["torch"]["cache_after"]),
                         jax.tree.leaves(out["jax"]["cache_after"])):
        if str(want.dtype) == "int8":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            n_codes += 1
        else:
            np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=TOL,
                                       atol=TOL)
    assert n_codes >= 2
