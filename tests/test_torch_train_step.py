"""The port's train step (``launch/steps.py: make_train_step``) against the
live JAX reference's, on the CPU, at each family's ``reduced()`` config
(``test_torch_support.ARCH_CASES``), B=2, S=32, the same params (drawn
from a numpy seed by each leaf's spec) and the same batch, the
reference's step through ``jax.jit``.

fp32 (every leaf cast): the loss within 1e-5 relative, every gradient
leaf within 1e-4 of that leaf's max|g|, the updated params within 1e-5 of
the reference's ``AdamW.update`` applied to the same gradients, and
within 1e-5 of the reference's own step wherever its |g| exceeds 100 eps
(below that, Adam's first update ``g / (|g| + eps)`` turns the two
libraries' last-bit gradient differences into O(lr) param differences).
bf16: the loss within 2e-2 relative, the LM slice's bf16 bound.

Then the counterparts of ``tests/test_system.py``: one train step, a
prefill and a decode per family; 30 steps on the synthetic task that cut
the loss by more than 0.3; microbatch accumulation against the full batch
to the reference's bounds, and against the reference's own microbatch
step. The remat policies give bit-identical grads, and ``"dots"`` saves
the matmuls ``"nothing"`` recomputes.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import steps as j_steps
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import steps as t_steps
from repro_torch.nn import model as t_model
from repro_torch.nn.dims import compute_dims
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from test_torch_support import (ARCH_CASES, arch_twin_cfgs, as_f32,
                                numpy_arch_params, one_torch_thread,
                                port_value_and_grad, train_batches)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
BF16_LOSS_RTOL = 2e-2
LR = 1e-3


@jax.jit
def _ref_update(jp, grads):
    """The reference's first AdamW update of ``jp`` by ``grads`` (its
    train step's optimizer half): (params, grad norm)."""
    opt = JAdamW(lr=LR)
    params, _, gnorm = opt.update(grads, opt.init(jp), jp)
    return params, gnorm


def _port_step(tc, td, tp, tb, opts=t_steps.StepOptions()):
    opt = AdamW(lr=LR)
    step = t_steps.make_train_step(tc, td, opt, opts)
    return step(t_steps.TrainState(tp, opt.init(tp)), tb)


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_train_step_matches_reference_fp32(case):
    jc, jd, tc, td = arch_twin_cfgs(case)
    jp, tp = numpy_arch_params(jc, jd, "f32")
    jb, tb = train_batches(jc, jd, "f32")
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_steps.make_loss_fn(
        jc, jd, j_steps.StepOptions())))(jp, jb)
    t_loss, t_g = port_value_and_grad(tc, td, tp, tb)
    assert abs(float(t_loss) - float(j_loss)) <= LOSS_RTOL * abs(float(j_loss))
    j_g = jax.tree.leaves(j_grads)
    assert len(t_g) == len(j_g)
    for got, want in zip(t_g, j_g):
        got, want = as_f32(got), as_f32(want)
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()

    state, m = _port_step(tc, td, tp, tb)
    assert float(m["step"]) == 1.0
    j_params, j_norm = _ref_update(jp, j_grads)
    assert abs(float(m["grad_norm"]) - float(j_norm)) <= \
        GRAD_TOL * float(j_norm)
    # the reference's optimizer on the port's own gradients
    want_params, _ = _ref_update(jp, jax.tree.unflatten(
        jax.tree.structure(jp), [jnp.asarray(as_f32(g)) for g in t_g]))
    eps_g = 100 * JAdamW().eps
    for got, want, ref, g in zip(tree_leaves(state.params),
                                 jax.tree.leaves(want_params),
                                 jax.tree.leaves(j_params), j_g):
        got = as_f32(got)
        np.testing.assert_allclose(got, as_f32(want), rtol=0, atol=PARAM_TOL)
        sure = np.abs(as_f32(g)) > eps_g
        np.testing.assert_allclose(got[sure], as_f32(ref)[sure], rtol=0,
                                   atol=PARAM_TOL)


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_train_step_bf16_loss_matches_reference(case):
    jc, jd, tc, td = arch_twin_cfgs(case)
    jp, tp = numpy_arch_params(jc, jd, "bf16")
    jb, tb = train_batches(jc, jd, "bf16")
    j_loss = jax.jit(j_steps.make_loss_fn(jc, jd, j_steps.StepOptions()))(
        jp, jb)
    state, m = _port_step(tc, td, tp, tb)
    assert abs(float(m["loss"]) - float(j_loss)) <= \
        BF16_LOSS_RTOL * abs(float(j_loss))
    assert np.isfinite(float(m["grad_norm"]))
    assert [p.dtype for p in tree_leaves(state.params)] == \
        [p.dtype for p in tree_leaves(numpy_arch_params(jc, jd)[1])]


def _arch(name):
    cfg = reduced(get_arch(name))
    return cfg, compute_dims(cfg, tp=1)


def _tokens_batch(cfg, dims, b, s, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    out = {"labels": toks[:, 1:]}
    if cfg.frontend == "text":
        out["tokens"] = toks[:, :-1]
    else:
        out["embeds"] = torch.randn((b, s, dims.d_model), generator=g
                                    ).to(dtype)
    return out


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_arch_smoke_train_and_serve(case):
    """One train step + prefill + decode per family (the port's own
    seeded params), finite, the right shapes."""
    _, _, cfg, dims = arch_twin_cfgs(case)
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    b, s = 2, 32
    batch = _tokens_batch(cfg, dims, b, s, 0)
    opt = AdamW(lr=1e-3)
    state = t_steps.TrainState(params, opt.init(params))
    state, metrics = t_steps.make_train_step(cfg, dims, opt)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0.5, (case, loss)

    prefill = t_steps.make_prefill_step(cfg, dims, s_max=s + 4)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = prefill(state.params, inputs)
    assert logits.shape == (b, dims.vocab)
    assert not bool(torch.isnan(logits).any())
    tok = (torch.zeros((b, 1), dtype=torch.long) if cfg.frontend == "text"
           else torch.randn((b, 1, dims.d_model)).bfloat16())
    logits2, cache = t_steps.make_decode_step(cfg, dims)(state.params, cache,
                                                         tok, s)
    assert logits2.shape == (b, dims.vocab)
    assert not bool(torch.isnan(logits2).any())


def test_training_reduces_loss():
    """30 steps on the synthetic copy task must actually learn."""
    cfg, dims = _arch("tinyllama-1.1b")
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    opt = AdamW(lr=3e-3)
    state = t_steps.TrainState(params, opt.init(params))
    step = t_steps.make_train_step(cfg, dims, opt)
    shape = ShapeSpec("tiny", 64, 8, "train")
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic_batch(i, cfg, dims, shape, DataConfig()).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]


def test_microbatch_accumulation_matches_full_batch():
    """The port's microbatch=2 step against its full batch to the
    reference's own bounds, and against the reference's microbatch=2
    step on the same params and batch (loss to the bf16 2e-2; the first
    leaf to the reference's own bounds)."""
    jc, jd, tc, td = arch_twin_cfgs("qkv_bias")
    jp, tp = numpy_arch_params(jc, jd, "bf16", seed=3)
    jb, tb = train_batches(jc, jd, "bf16", b=4, s=32, seed=3)
    s1, m1 = _port_step(tc, td, tp, tb)
    _, tp2 = numpy_arch_params(jc, jd, "bf16", seed=3)
    s2, m2 = _port_step(tc, td, tp2, tb, t_steps.StepOptions(microbatch=2))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    l1 = tree_leaves(s1.params)[0].float().numpy()
    l2 = tree_leaves(s2.params)[0].float().numpy()
    np.testing.assert_allclose(l1, l2, atol=5e-2, rtol=0.2)

    opt = JAdamW(lr=LR)
    micro = jax.jit(j_steps.make_train_step(
        jc, jd, opt, j_steps.StepOptions(microbatch=2)))
    js, jm = micro(j_steps.TrainState(jp, opt.init(jp)), jb)
    assert abs(float(m2["loss"]) - float(jm["loss"])) <= \
        BF16_LOSS_RTOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(l2, as_f32(jax.tree.leaves(js.params)[0]),
                               atol=5e-2, rtol=0.2)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["dense", "moe", "ssm", "hybrid_tail"])
def test_remat_policies_give_bit_identical_grads(case):
    """remat off, "nothing" and "dots": the same loss and grads bit for
    bit; the backward of "nothing" recomputes the forward's matmuls, that
    of "dots" none of them (it runs as many as no remat)."""
    _, _, cfg, dims = arch_twin_cfgs(case)
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    batch = _tokens_batch(cfg, dims, 2, 32, 1)
    got, mms = [], []
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        opts = t_steps.StepOptions(remat=remat, remat_policy=policy)
        loss_fn = t_steps.make_loss_fn(cfg, dims, opts)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                        materialize_grads=True)
        got.append((loss.detach(), grads))
        mms.append(count.n)
    for loss, grads in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, got[0][1]))
    assert mms[1] > mms[0] == mms[2], mms


def test_remat_policy_must_be_known():
    cfg, dims = _arch("tinyllama-1.1b")
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    with pytest.raises(ValueError, match="remat policy"):
        t_model.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg,
                        dims, remat_policy="everything")
