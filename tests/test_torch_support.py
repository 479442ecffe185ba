"""Shared helpers for the PyTorch port's tests (``tests/test_torch_*.py``),
plus checks of the helpers themselves.

The port and the JAX reference are held against each other on the same
numpy inputs. Both packages' ``Graph`` classes share one API, so
:func:`cnet_like` builds the CNet-shaped graph in either package from the
same calls; a narrow width keeps the JAX interpret-mode kernels fast.
"""
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

from fractions import Fraction

import jax
import numpy as np
import torch

from repro.core.engine import Engine as JEngine
from repro.core.opgraph import Graph as JGraph
from repro.models.common import init_graph_params
from repro_torch.convert import calibration_from_numpy, params_from_numpy
from repro_torch.core.engine import Engine as TEngine
from repro_torch.kernels.epilogue import fma_f32
from repro_torch.models import cnet_plus_scalar as tcnet

NARROW = dict(input_shape=(32, 32, 2), channels=(8, 8, 4), dense=12)


def cnet_like(graph_cls, input_shape=(32, 32, 2), channels=(8, 8, 4),
              dense=12):
    """CNetPlusScalar's builder, written against either package's Graph."""
    g = graph_cls("cnet_plus_scalar")
    x = g.input("image", tuple(input_shape))
    s = g.input("background_flux", (1,))
    for i, c in enumerate(channels):
        x = g.add("conv2d", [x], name=f"conv{i}", kernel=(3, 3), features=c,
                  stride=1, padding="SAME")
        x = g.add("relu", [x], name=f"act{i}")
        x = g.add("maxpool2d", [x], name=f"pool{i}", kernel=2)
    x = g.add("flatten", [x], name="flatten")
    x = g.add("concat", [x, s], name="concat_scalar", axis=0)
    x = g.add("dense", [x], name="fc1", features=dense)
    x = g.add("relu", [x], name="fc1_act")
    y = g.add("dense", [x], name="head", features=1)
    g.mark_output(y)
    return g


def graph_signature(g):
    """Everything a graph's identity is made of, comparable across the two
    packages."""
    nodes = [(n, g.nodes[n].op, g.nodes[n].inputs,
              sorted((k, repr(v)) for k, v in g.nodes[n].attrs.items()),
              g.nodes[n].out_shape, g.nodes[n].param_count,
              g.nodes[n].bias_params, g.nodes[n].macs, g.nodes[n].ops)
             for n in g.order]
    return (g.name, nodes, dict(g.graph_inputs), list(g.outputs), g.n_macs,
            g.n_params, g.n_ops, g.param_bytes())


def to_numpy_params(params):
    return {n: {k: np.asarray(v) for k, v in p.items()}
            for n, p in params.items()}


def twin_engines(n_calib=4, seed=1, widths=NARROW, carry=True, **kw):
    """A calibrated JAX engine and a CPU port engine on the same params
    (drawn on the JAX side) and graph. ``carry`` hands the JAX calibration
    to the port; otherwise the port calibrates itself on the same
    samples. Returns (jax_engine, port_engine, calibration samples)."""
    jg = cnet_like(JGraph, **widths)
    tg = tcnet.build_graph(**widths)
    jp = init_graph_params(jg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    samples = [tcnet.synthetic_input(rng, widths["input_shape"])
               for _ in range(n_calib)]
    je = JEngine(jg, jp, **kw)
    je.calibrate(samples)
    te = TEngine(tg, params_from_numpy(to_numpy_params(jp), "cpu"),
                 device="cpu", **kw)
    if carry:
        te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                                   "cpu"))
    else:
        te.calibrate(samples)
    return je, te, samples


def fault_twins(names, **kw):
    """The reference fault tests' engines and their port twins:
    ``{name: (jax_model, jax_engine, port_engine)}``, params drawn on the
    JAX side (key 0), the reference calibrated on its 2-sample set
    (keys 0 and 1, as numpy) and the calibration carried to the CPU port
    engine, so both plans hold the same int8 weight arenas. ``kw`` goes
    to both engines."""
    from repro.models import SPACE_MODELS as j_models
    from repro_torch.models import SPACE_MODELS as t_models
    out = {}
    for name in names:
        m = j_models[name]
        jp = m.init_params(jax.random.PRNGKey(0))
        je = JEngine(m.build_graph(), jp, **kw)
        je.calibrate([{k: np.asarray(v) for k, v in
                       m.synthetic_input(jax.random.PRNGKey(i)).items()}
                      for i in range(2)])
        te = TEngine(t_models[name].build_graph(),
                     params_from_numpy(to_numpy_params(jp), "cpu"),
                     device="cpu", **kw)
        te.load_calibration(calibration_from_numpy(je._calib, je._ptq_err,
                                                   "cpu"))
        out[name] = (m, je, te)
    return out


def storm(side, engines, names, n, upsets=(), stop_at=None, serve=True,
          backends=("accel", "cpu"), ladder=(1, 4), **cfg):
    """One modeled-clock fault storm as the reference fault tests drive
    it, on the reference (``side="jax"``) or the port (``"torch"``): the
    models registered on ``backends`` over ``ladder`` with a warm-up
    request, ``n`` requests each on a bursty trace, a controller over
    ``FaultConfig(**cfg)`` with ``upsets`` given as ``UpsetEvent``
    argument tuples, armed on each model's canary request. Returns
    (scheduler, controller, trace)."""
    from repro.core import faults as jfaults
    from repro.core import radiation as jrad
    from repro.core.scheduler import ContinuousBatchingScheduler as JSched
    from repro.core.scheduler import bursty_arrivals
    from repro.models import synthetic_requests
    from repro_torch.core import faults as tfaults
    from repro_torch.core import radiation as trad
    from repro_torch.core.scheduler import ContinuousBatchingScheduler
    sched_cls, fmod, rmod = {
        "jax": (JSched, jfaults, jrad),
        "torch": (ContinuousBatchingScheduler, tfaults, trad)}[side]
    sched = sched_cls(clock="modeled")
    trace = []
    for mi, name in enumerate(names):
        m, je, te = engines[name]
        reqs = synthetic_requests(m, n, seed=5 + mi)
        sched.register(name, je if side == "jax" else te, backend=backends,
                       ladder=ladder, warmup_sample=reqs[0])
        trace += [(t, name, r) for t, r in
                  zip(bursty_arrivals(n, burst_size=4, gap_s=0.01,
                                      seed=20 + mi), reqs)]
    ctl = fmod.FaultController(fmod.FaultConfig(
        upsets=tuple(rmod.UpsetEvent(*u) for u in upsets), **cfg))
    sched.attach_faults(ctl)
    for mi, name in enumerate(names):
        ctl.arm(sched, name, synthetic_requests(engines[name][0], 1,
                                                seed=5 + mi))
    if serve:
        sched.serve_trace(trace, stop_at=stop_at)
    return sched, ctl, trace


# ---------------------------------------------------------------------------
# the large-model stack (configs/, nn/, launch/steps.py)
# ---------------------------------------------------------------------------

# one reduced() config per family and feature, plus a hybrid with a tail:
# name -> (arch, num_layers override or None)
ARCH_CASES = {
    "dense": ("tinyllama-1.1b", None),
    "qkv_bias": ("qwen1.5-0.5b", None),
    "moe": ("llama4-scout-17b-a16e", None),
    "ssm": ("mamba2-780m", None),
    "hybrid": ("zamba2-1.2b", None),
    "embed": ("musicgen-large", None),
    "hybrid_tail": ("zamba2-1.2b", 5),      # 2 groups of 2 + 1 tail layer
}
ATTENDING = ("dense", "qkv_bias", "moe", "hybrid", "embed", "hybrid_tail")


def arch_twin_cfgs(case, kv_quant=False):
    """``(jax cfg, jax dims, port cfg, port dims)`` of an ``ARCH_CASES``
    entry."""
    import dataclasses
    from repro.configs import get_arch as j_get, reduced as j_reduced
    from repro.nn.dims import compute_dims as j_dims
    from repro_torch.configs import get_arch as t_get, reduced as t_reduced
    from repro_torch.nn.dims import compute_dims as t_dims
    arch, layers = ARCH_CASES[case]
    over = {"kv_quant": kv_quant}
    if layers:
        over["num_layers"] = layers
    jc = dataclasses.replace(j_reduced(j_get(arch)), **over)
    tc = dataclasses.replace(t_reduced(t_get(arch)), **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, j_dims(jc), tc, t_dims(tc)


def arch_twin_params(jc, jd, dtype="bf16", key=0):
    """The reference's ``init_params`` (bf16; ``dtype="f32"`` casts every
    leaf), and the same values as the port's tree on the CPU."""
    import jax.numpy as jnp
    from repro.nn import model as j_model
    from repro_torch.convert import tree_from_numpy
    jp = j_model.init_params(jc, jd, jax.random.PRNGKey(key))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def arch_inputs(jc, jd, b, s, dtype="bf16", seed=0):
    """``(jax batch, port batch)``: token ids, or frame embeddings (fp32
    values, bf16 unless ``dtype="f32"``) for an embedding front end, from
    a numpy seed; ``s`` positions each."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    if jc.frontend == "text":
        toks = rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)
        return ({"tokens": jnp.asarray(toks)},
                {"tokens": torch.from_numpy(toks).long()})
    emb = rng.standard_normal((b, s, jd.d_model)).astype(np.float32)
    if dtype == "f32":
        return {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
    return ({"embeds": jnp.asarray(emb, jnp.bfloat16)},
            {"embeds": torch.from_numpy(emb).bfloat16()})


def as_f32(a) -> np.ndarray:
    """A jax array or a tensor as float32 numpy (bf16 widened)."""
    if isinstance(a, torch.Tensor):                  # a copy: caches change
        return a.float().numpy().copy()
    return np.asarray(a.astype("float32") if a.dtype.name == "bfloat16"
                      else a, np.float32)


ARCH_B, ARCH_S, ARCH_STEPS = 2, 40, 4


def arch_run_both(case, dtype, impl, kv_quant=False):
    """Both packages on the same params and inputs (``ARCH_B`` rows):
    the ``train``-mode logits of the first ``ARCH_S`` positions, the
    prefill step's next-token logits and cache (capacity ``ARCH_S +
    ARCH_STEPS``), and ``ARCH_STEPS`` decode steps fed the inputs' next
    positions (so both sides see the same tokens). The reference's steps
    run through ``jax.jit``, as its launcher runs them. Returns
    ``{"jax"|"torch": {"train", "prefill", "cache" (fp32 numpy copies of
    the prefill cache's leaves, sorted-key order), "decode": [...],
    "cache_after"}}``."""
    import jax.numpy as jnp
    from repro.launch import steps as j_steps
    from repro.nn import model as j_model
    from repro_torch.launch import steps as t_steps
    from repro_torch.nn import model as t_model
    from repro_torch.nn.params import tree_leaves
    jc, jd, tc, td = arch_twin_cfgs(case, kv_quant)
    jp, tp = arch_twin_params(jc, jd, dtype)
    jb, tb = arch_inputs(jc, jd, ARCH_B, ARCH_S + ARCH_STEPS, dtype)
    key = "tokens" if jc.frontend == "text" else "embeds"
    s, s_max = ARCH_S, ARCH_S + ARCH_STEPS
    out = {}

    jx = jb[key]
    j_fwd = jax.jit(lambda p, x: j_model.forward(
        p, x, jc, jd, mode="train", attn_impl=impl, remat=False))
    j_pre = jax.jit(j_steps.make_prefill_step(
        jc, jd, j_steps.StepOptions(attn_impl=impl), s_max=s_max))
    j_dec = jax.jit(j_steps.make_decode_step(jc, jd))
    logits, cache = j_pre(jp, {key: jx[:, :s]})
    res = {"train": j_fwd(jp, jx[:, :s]), "prefill": logits,
           "cache": [as_f32(a) for a in jax.tree.leaves(cache)],
           "decode": []}
    for i in range(ARCH_STEPS):
        logits, cache = j_dec(jp, cache, jx[:, s + i:s + i + 1],
                              jnp.int32(s + i))
        res["decode"].append(logits)
    res["cache_after"] = cache
    out["jax"] = res

    tx = tb[key]
    t_pre = t_steps.make_prefill_step(
        tc, td, t_steps.StepOptions(attn_impl=impl), s_max=s_max)
    t_dec = t_steps.make_decode_step(tc, td)
    logits, cache = t_pre(tp, {key: tx[:, :s]})
    res = {"train": t_model.forward(tp, tx[:, :s], tc, td, attn_impl=impl),
           "prefill": logits,
           "cache": [as_f32(a) for a in tree_leaves(cache)], "decode": []}
    for i in range(ARCH_STEPS):
        logits, cache = t_dec(tp, cache, tx[:, s + i:s + i + 1], s + i)
        res["decode"].append(logits)
    res["cache_after"] = cache
    out["torch"] = res
    return out


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = as_f32(want)
    return float(np.max(np.abs(as_f32(got) - want)) / np.max(np.abs(want)))


def logit_errors(out) -> list:
    """``rel_err`` of the train, prefill and each decode step's logits."""
    j, t = out["jax"], out["torch"]
    return ([rel_err(t["train"], j["train"]),
             rel_err(t["prefill"], j["prefill"])]
            + [rel_err(a, b) for a, b in zip(t["decode"], j["decode"])])


# ---------------------------------------------------------------------------
# training (launch/steps.py's train half, optim/)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 32


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test: the training tests' tensors are
    tiny, and under several test workers each holding a thread per core
    torch's CPU threads oversubscribe the cores and its small ops run
    hundreds of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_arch_params(jc, jd, dtype="bf16", seed=0):
    """The reference's param tree with each leaf drawn by its spec's init
    from a numpy seed (a normal leaf: a standard normal clipped to [-2, 2]
    times the spec's scale), as ``(jax tree, port tree on the CPU)``;
    ``dtype="f32"`` keeps every leaf fp32. Cheaper than the reference's
    ``init_params``, which compiles a draw per leaf shape."""
    import jax.numpy as jnp
    from repro.nn import model as j_model
    from repro.nn.params import is_spec
    from repro_torch.convert import tree_from_numpy
    rng = np.random.default_rng(seed)
    want = jnp.float32 if dtype == "f32" else jnp.bfloat16

    def one(sp):
        if sp.init == "zeros":
            a = np.zeros(sp.shape, np.float32)
        elif sp.init == "ones":
            a = np.ones(sp.shape, np.float32)
        else:
            a = np.clip(rng.standard_normal(sp.shape), -2, 2) * sp.scale
        return jnp.asarray(a, jnp.float32).astype(
            want if dtype == "f32" else sp.dtype)

    jp = jax.tree.map(one, j_model.model_spec(jc, jd), is_leaf=is_spec)
    return jp, tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def train_batches(jc, jd, dtype="bf16", b=TRAIN_B, s=TRAIN_S, seed=1):
    """``(jax batch, port batch)`` of ``arch_inputs`` plus random labels."""
    import jax.numpy as jnp
    jb, tb = arch_inputs(jc, jd, b, s, dtype, seed)
    labels = np.random.default_rng(seed + 100).integers(
        0, jc.vocab_size, (b, s)).astype(np.int32)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels).long()
    return jb, tb


def port_value_and_grad(tc, td, params, batch, opts=None):
    """The port's loss and the grads of every leaf (sorted-key order)."""
    from repro_torch.launch import steps as t_steps
    from repro_torch.nn.params import tree_leaves, tree_map
    loss_fn = t_steps.make_loss_fn(tc, td, opts or t_steps.StepOptions())
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                materialize_grads=True)
    return loss.detach(), list(grads)


# ---------------------------------------------------------------------------
# checks of the helpers
# ---------------------------------------------------------------------------


def test_fma_f32_is_correctly_rounded():
    """fma_f32 against exact rational arithmetic: the result is a nearest
    float32 to a*b + c, including on operands built to make the float64
    sum land on a float32 rounding boundary."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    # adversarial: c cancels most of a*b, leaving the low product bits
    c[:200] = -(a[:200].astype(np.float64) * b[:200]).astype(np.float32)
    c[200:300] *= np.float32(2.0 ** -30)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for ai, bi, ci, r in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        r = np.float32(r)
        for nb in (np.nextafter(r, np.float32(np.inf)),
                   np.nextafter(r, np.float32(-np.inf))):
            assert abs(exact - Fraction(float(r))) <= \
                abs(exact - Fraction(float(nb)))


def test_cnet_like_matches_port_builder():
    assert (graph_signature(cnet_like(JGraph, **NARROW))
            == graph_signature(tcnet.build_graph(**NARROW)))
