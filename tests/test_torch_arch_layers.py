"""The large-model stack's modules (``configs/``, ``nn/``,
``core/lm_quant.py``'s weight half) one by one against the live JAX
reference, and the counterparts of the reference's own model tests on
the port alone.

* configs: the registry, every arch's fields, ``reduced()`` and
  ``param_count()`` equal the reference's;
* specs: ``count_params(model_spec(cfg, dims))`` equals the reference's
  for all ten archs, from the specs alone (the abstract params live on
  the ``meta`` device: nothing is allocated);
* each layer function against its JAX function on the same fp32 inputs,
  within 1e-5 relative (the fp32 libraries sum in other orders), the
  attention's ``pallas`` path against the reference's Pallas kernel in
  interpret mode; ``ssd_chunked`` against the reference's at its own
  tolerances (2e-3 / 1e-3, tests/test_model_math.py);
* tests/test_model_math.py's invariants on the port, with its tolerances:
  causality (atol 1e-2), prefill/decode consistency (atol 0.15, rtol
  0.05), ``ssd_chunked`` against the naive recurrence, chunked attention
  against naive (1e-5), the parameter count within 2% of the analytic;
* tests/test_perf_features.py's int8 KV consistency (rel < 0.08) and the
  weight PTQ round trip and axes; ``quantize_params``' codes and scales
  bit-exact to the reference's (eager, as its launcher calls it) and
  ``dequantize_params`` equal.
"""
import dataclasses

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro.core import lm_quant as j_lmq
from repro.nn import attention as j_attn
from repro.nn import layers as j_layers
from repro.nn import model as j_model
from repro.nn import moe as j_moe
from repro.nn import ssm as j_ssm
from repro.nn.dims import compute_dims as j_dims
from repro.nn.params import count_params as j_count
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy
from repro_torch.core import lm_quant as t_lmq
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import model as t_model
from repro_torch.nn import moe as t_moe
from repro_torch.nn import ssm as t_ssm
from repro_torch.nn.dims import compute_dims as t_dims
from repro_torch.nn.params import count_params as t_count
from repro_torch.nn.params import tree_leaves, tree_map
from test_torch_support import arch_twin_cfgs, arch_twin_params, as_f32

TOL = 1e-5
FAMILIES = ["tinyllama-1.1b", "llama4-scout-17b-a16e", "mamba2-780m",
            "zamba2-1.2b"]


def _close(got, want, tol=TOL):
    want = as_f32(want)
    err = np.max(np.abs(as_f32(got) - want)) / max(np.max(np.abs(want)),
                                                    1e-30)
    assert err <= tol, err


def _x(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _f32_params(case):
    jc, jd, tc, td = arch_twin_cfgs(case)
    jp, tp = arch_twin_params(jc, jd, "f32")
    return jc, jd, tc, td, jp, tp


def _layer(jtree, ttree, i):
    return jax.tree.map(lambda a: a[i], jtree), tree_map(lambda a: a[i],
                                                         ttree)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------


def test_configs_equal_the_references():
    assert t_configs.all_archs() == j_configs.all_archs()
    assert len(t_configs.all_archs()) == 10
    for arch in j_configs.all_archs():
        jc, tc = j_configs.get_arch(arch), t_configs.get_arch(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (dataclasses.asdict(t_configs.reduced(tc))
                == dataclasses.asdict(j_configs.reduced(jc)))
        assert tc.param_count() == jc.param_count()
        assert ([s.name for s in t_configs.shapes_for(tc)]
                == [s.name for s in j_configs.shapes_for(jc)])


@pytest.mark.parametrize("arch", sorted(j_configs.all_archs()))
def test_count_params_equals_the_references_from_specs_alone(arch):
    jc, tc = j_configs.get_arch(arch), t_configs.get_arch(arch)
    td = t_dims(tc)
    assert dataclasses.asdict(td) == dataclasses.asdict(j_dims(jc))
    spec = t_model.model_spec(tc, td)
    assert t_count(spec) == j_count(j_model.model_spec(jc, j_dims(jc)))
    abstract = t_model.abstract_model_params(tc, td)
    assert all(a.is_meta for a in tree_leaves(abstract))
    axes = t_model.param_axes(tc, td)
    j_axes = j_model.param_axes(jc, j_dims(jc))
    assert tree_leaves(axes) == jax.tree.leaves(
        j_axes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b",
                                  "mamba2-780m"])
def test_param_count_analytic_vs_actual(arch):
    cfg = t_configs.get_arch(arch)
    actual = t_count(t_model.model_spec(cfg, t_dims(cfg)))
    assert abs(actual - cfg.param_count()) / cfg.param_count() < 0.02


def test_init_params_are_seeded_per_leaf():
    tc = t_configs.reduced(t_configs.get_arch("tinyllama-1.1b"))
    td = t_dims(tc)
    a = t_model.init_params(tc, td, torch.Generator().manual_seed(3), "cpu")
    b = t_model.init_params(tc, td, torch.Generator().manual_seed(3), "cpu")
    c = t_model.init_params(tc, td, torch.Generator().manual_seed(4), "cpu")
    la, lb, lc = tree_leaves(a), tree_leaves(b), tree_leaves(c)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    w = a["groups"]["attn"]["w_q"]
    assert w.dtype == torch.bfloat16 and not torch.equal(
        w, c["groups"]["attn"]["w_q"])
    # truncated at 2 x the 0.02 scale, then rounded to bf16
    assert float(w.float().abs().max()) <= float(torch.tensor(0.04).bfloat16())
    assert torch.equal(a["final_norm"], torch.ones_like(a["final_norm"]))


# ---------------------------------------------------------------------------
# layers against the reference (fp32)
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, 2, 9, 4, 16)
    js, ts = _x(rng, 16)
    _close(t_layers.rmsnorm(tx, ts, 1e-5), jax.jit(j_layers.rmsnorm)(jx, js))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 5, (2, 9)).copy()
    for theta in (10_000.0, 500_000.0):
        want = jax.jit(j_layers.apply_rope, static_argnums=2)(
            jx, jnp.asarray(pos), theta)
        _close(t_layers.apply_rope(tx, torch.from_numpy(pos), theta), want)


def test_mlp_matches_reference():
    jc, jd, tc, td, jp, tp = _f32_params("dense")
    jmlp, tmlp = _layer(jp["groups"]["mlp"], tp["groups"]["mlp"], 0)
    jx, tx = _x(np.random.default_rng(1), 2, 7, jd.d_model)
    _close(t_layers.mlp(tmlp, tx), jax.jit(j_layers.mlp)(jmlp, jx))


@pytest.mark.parametrize("impl,s,chunk", [("chunked", 48, 16),
                                          ("naive", 20, 512),
                                          ("pallas", 37, 512)])
@pytest.mark.parametrize("case", ["dense", "qkv_bias"])
def test_multihead_attention_matches_reference(case, impl, s, chunk):
    jc, jd, tc, td, jp, tp = _f32_params(case)
    ja, ta = _layer(jp["groups"]["attn"], tp["groups"]["attn"], 0)
    if case == "qkv_bias":   # the reference inits biases to zero
        rng = np.random.default_rng(5)
        for k in ("b_q", "b_k", "b_v"):
            b = rng.standard_normal(ja[k].shape).astype(np.float32) * 0.1
            ja[k], ta[k] = jnp.asarray(b), torch.from_numpy(b)
    jx, tx = _x(np.random.default_rng(2), 2, s, jd.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want_y, want_kv = jax.jit(lambda p, x: j_attn.multihead_attention(
        p, x, jc, jd, jnp.asarray(pos), impl=impl, chunk=chunk,
        return_kv=True, s_max=s + 3))(ja, jx)
    got_y, got_kv = t_attn.multihead_attention(
        ta, tx, tc, td, torch.from_numpy(pos), impl=impl, chunk=chunk,
        return_kv=True, s_max=s + 3)
    _close(got_y, want_y)
    for k in ("k", "v"):
        _close(got_kv[k], want_kv[k])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_attention_matches_reference(kv_quant):
    jc, jd, tc, td = arch_twin_cfgs("dense", kv_quant)
    jp, tp = arch_twin_params(jc, jd, "f32")
    ja, ta = _layer(jp["groups"]["attn"], tp["groups"]["attn"], 0)
    rng = np.random.default_rng(3)
    s_max, pos = 12, 7
    kv = rng.standard_normal((2, s_max, jd.num_kv_heads,
                              jd.head_dim)).astype(np.float32)
    if kv_quant:
        q, sc = jax.jit(j_lmq.quantize_kv)(jnp.asarray(kv))
        jcache = {"k_q": q, "k_s": sc, "v_q": q[:, ::-1], "v_s": sc[:, ::-1]}
    else:
        jcache = {"k": jnp.asarray(kv), "v": jnp.asarray(kv[:, ::-1])}
    tcache = tree_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    jx, tx = _x(rng, 2, 1, jd.d_model)
    want, want_c = jax.jit(lambda p, x, c: j_attn.decode_attention(
        p, x, c, jnp.int32(pos), jc, jd))(ja, jx, jcache)
    got, got_c = t_attn.decode_attention(ta, tx, tcache, pos, tc, td)
    _close(got, want)
    for k in want_c:
        if str(want_c[k].dtype) == "int8":
            np.testing.assert_array_equal(got_c[k].numpy(),
                                          np.asarray(want_c[k]))
        else:
            _close(got_c[k], want_c[k])


@pytest.mark.parametrize("case", ["ssm", "hybrid"])
def test_ssm_mixer_and_decode_step_match_reference(case):
    jc, jd, tc, td, jp, tp = _f32_params(case)
    jg, tg = jp["groups"], tp["groups"]
    if case == "hybrid":
        jg, tg = _layer(jg["ssm_subs"], tg["ssm_subs"], 0)
    js, ts = _layer(jg["ssm"], tg["ssm"], 1)
    jx, tx = _x(np.random.default_rng(4), 2, 45, jd.d_model)
    want, want_c = jax.jit(lambda p, x: j_ssm.ssm_mixer(
        p, x, jc, jd, return_cache=True))(js, jx)
    got, got_c = t_ssm.ssm_mixer(ts, tx, tc, td, return_cache=True)
    _close(got, want)
    for k in want_c:
        _close(got_c[k], want_c[k])
    j1, t1 = _x(np.random.default_rng(5), 2, 1, jd.d_model)
    want, want_c = jax.jit(lambda p, x, c: j_ssm.ssm_decode_step(
        p, x, c, jc, jd))(js, j1, want_c)
    got, got_c = t_ssm.ssm_decode_step(ts, t1, got_c, tc, td)
    _close(got, want)
    for k in want_c:
        _close(got_c[k], want_c[k])


@pytest.mark.parametrize("b,s", [(2, 9), (4, 33)])
def test_moe_ffn_matches_reference(b, s):
    jc, jd, tc, td, jp, tp = _f32_params("moe")
    jm, tm = _layer(jp["groups"]["moe"]["moe"], tp["groups"]["moe"]["moe"],
                    0)
    # a wider router than init's 0.006 spreads the tokens over the experts
    r = np.random.default_rng(6).standard_normal(
        jm["router"].shape).astype(np.float32)
    jm["router"], tm["router"] = jnp.asarray(r), torch.from_numpy(r)
    jx, tx = _x(np.random.default_rng(7), b, s, jd.d_model)
    want = jax.jit(lambda p, x: j_moe.moe_ffn(p, x, jc, jd))(jm, jx)
    _close(t_moe.moe_ffn(tm, tx, tc, td), want)
    assert t_moe._capacity(b * s, tc) == j_moe._capacity(b * s, jc)


@pytest.mark.parametrize("chunk", [8, 16, 64, 13])
def test_ssd_chunked_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    b, s, h, p, n = 2, 64, 3, 8, 16
    args = [rng.standard_normal((b, s, h, p)), rng.standard_normal((b, s, n)),
            rng.standard_normal((b, s, n)), rng.random((b, s, h)) * 0.5 + 0.1,
            -np.exp(rng.standard_normal(h) * 0.3)]
    args = [a.astype(np.float32) for a in args]
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    yj, fj = j_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                               init_state=jnp.asarray(init))
    yt, ft = t_ssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                               torch.from_numpy(init))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=2e-3,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_model_math.py on the port
# ---------------------------------------------------------------------------


def _setup(arch, seed=0):
    cfg = t_configs.reduced(t_configs.get_arch(arch))
    dims = t_dims(cfg)
    params = t_model.init_params(cfg, dims,
                                 torch.Generator().manual_seed(seed), "cpu")
    return cfg, dims, params


@pytest.mark.parametrize("arch", FAMILIES)
def test_causality(arch):
    # b=1: capacity-based MoE dispatch couples the sequences of a batch
    cfg, dims, params = _setup(arch)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    logits1 = t_model.forward(params, toks, cfg, dims)
    toks2 = toks.clone()
    toks2[:, -1] = (toks[:, -1] + 7) % cfg.vocab_size
    logits2 = t_model.forward(params, toks2, cfg, dims)
    np.testing.assert_allclose(as_f32(logits1[:, :-1]),
                               as_f32(logits2[:, :-1]), atol=1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_consistency(arch):
    """logits(prefill S tokens, decode token S) == logits(forward S+1)."""
    cfg, dims, params = _setup(arch)
    b, s = 2, 33
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    full = t_model.forward(params, toks, cfg, dims)
    _, cache = t_model.forward(params, toks[:, :-1], cfg, dims,
                               mode="prefill", s_max=s)
    dec, _ = t_model.decode(params, toks[:, -1:], cache, s - 1, cfg, dims)
    np.testing.assert_allclose(as_f32(full[:, -1]), as_f32(dec[:, 0]),
                               atol=0.15, rtol=0.05)


def test_ssd_chunked_matches_naive_recurrence():
    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 64, 3, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    state = np.zeros((b, h, p, n), np.float32)
    ys = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        state = state * decay[:, :, None, None] + np.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhpn->bhp", C[:, t], state)
    for chunk in (8, 16, 64):
        y, final = t_ssm.ssd_chunked(*map(torch.from_numpy, (x, B, C, dt, A)),
                                     chunk)
        np.testing.assert_allclose(y.numpy(), ys, atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(final.numpy(), state, atol=2e-3,
                                   rtol=1e-3)


def test_chunked_attention_matches_naive():
    rng = np.random.default_rng(1)
    b, s, hq, hkv, hd = 2, 128, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                             (b, s, hkv, hd)))
    qg = t_attn._group(q, hkv)
    naive = t_attn._attend_naive(qg, k, v, hd ** -0.5)
    # 32 divides S; 48 does not (the last chunk is shorter)
    for chunk in (32, 48):
        chunked = t_attn._attend_chunked(qg, k, v, hd ** -0.5, chunk=chunk)
        np.testing.assert_allclose(naive.numpy(), chunked.numpy(),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# tests/test_perf_features.py on the port; the weight PTQ against the
# reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_kv8_prefill_decode_consistency(arch):
    cfg0 = t_configs.reduced(t_configs.get_arch(arch))
    cfg = dataclasses.replace(cfg0, kv_quant=True)
    dims = t_dims(cfg)
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    b, s = 2, 33
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(2))
    full = t_model.forward(params, toks, cfg0, dims)
    _, cache = t_model.forward(params, toks[:, :-1], cfg, dims,
                               mode="prefill", s_max=s)
    leaves = tree_leaves(cache)
    assert any(a.dtype == torch.int8 for a in leaves)
    shapes = [a.shape for a in leaves]
    dec, new_cache = t_model.decode(params, toks[:, -1:], cache, s - 1, cfg,
                                    dims)
    a, c = as_f32(full[:, -1]), as_f32(dec[:, 0])
    rel = np.abs(a - c).max() / (np.abs(a).max() + 1e-9)
    assert rel < 0.08, rel
    assert [x.shape for x in tree_leaves(new_cache)] == shapes


def test_lm_quant_roundtrip_and_axes():
    cfg = t_configs.reduced(t_configs.get_arch("qwen1.5-0.5b"), width=256)
    dims = t_dims(cfg)
    params = t_model.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                 "cpu")
    q = t_lmq.quantize_params(params)
    back = t_lmq.dequantize_params(q)
    assert tree_map(lambda _: 0, back) == tree_map(lambda _: 0, params)
    back32 = t_lmq.dequantize_params(q, dtype=torch.float32)
    emb = params["embed"]["embedding"].float()
    emb_q = q["embed"]["embedding"]
    assert emb_q["q"].dtype == torch.int8
    err = (emb - back32["embed"]["embedding"]).abs().max()
    assert float(err) <= float(emb_q["s"]) * 0.51 + 1e-6
    p_axes = t_model.param_axes(cfg, dims)
    q_axes = t_lmq.quantized_axes(t_model.abstract_model_params(cfg, dims),
                                  p_axes)
    assert tree_map(lambda _: 0, q_axes) == tree_map(lambda _: 0, q)
    abstract = t_lmq.abstract_quantized(t_model.abstract_model_params(
        cfg, dims))
    assert tree_map(lambda a: (tuple(a.shape), a.dtype), abstract) == \
        tree_map(lambda a: (tuple(a.shape), a.dtype), q)


@pytest.mark.parametrize("case", ["qkv_bias", "moe", "hybrid"])
def test_quantize_params_bit_exact_to_reference(case):
    jc, jd = arch_twin_cfgs(case)[:2]
    jc = dataclasses.replace(jc, d_model=256, d_ff=512)
    jd = j_dims(jc)
    jp = j_model.init_params(jc, jd, jax.random.PRNGKey(1))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jq, tq = j_lmq.quantize_params(jp), t_lmq.quantize_params(tp)
    n_q = 0
    for got, want in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        if got.dtype == torch.bfloat16:
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        n_q += got.dtype == torch.int8
    assert n_q >= 4
    for got, want in zip(tree_leaves(t_lmq.dequantize_params(tq)),
                         jax.tree.leaves(j_lmq.dequantize_params(jq))):
        np.testing.assert_array_equal(as_f32(got), as_f32(want))


@pytest.mark.parametrize("case", ["dense", "moe", "hybrid_tail"])
def test_init_caches_are_zeroed_with_the_references_shapes(case):
    jc, jd, tc, td = arch_twin_cfgs(case, kv_quant=case == "moe")
    want = j_model.init_cache(jc, jd, 2, 12)
    got = t_model.init_cache(tc, td, 2, 12, "cpu")
    pairs = list(zip(tree_leaves(got), jax.tree.leaves(want)))
    assert len(pairs) == len(jax.tree.leaves(want)) > 0
    for t, j in pairs:
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
        assert not bool(t.float().abs().max())
    kv = t_attn.init_kv_cache(2, 12, td, quant=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in kv.items()} == {
        k: tuple(v.shape) for k, v in j_attn.kv_cache_spec(
            2, 12, jd, quant=True).items()}
    if tc.ssm is not None:
        ssm = t_ssm.init_ssm_cache(2, tc, td, device="cpu")
        assert {k: tuple(v.shape) for k, v in ssm.items()} == {
            k: v.shape for k, v in j_ssm.init_ssm_cache(2, jc, jd).items()}


def test_prefill_forward_is_the_prefill_steps_logits():
    from repro_torch.launch import steps as t_steps
    cfg, dims, params = _setup("zamba2-1.2b")
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(4))
    opts = t_steps.StepOptions(attn_impl="pallas")
    got = t_steps.make_prefill_forward(cfg, dims, opts)(params,
                                                         {"tokens": toks})
    want, _ = t_steps.make_prefill_step(cfg, dims, opts)(params,
                                                         {"tokens": toks})
    assert torch.equal(got, want) and got.shape == (2, dims.vocab)
