"""bf16 noise at depth, in the reference and in the port: zamba2-1.2b
(38 Mamba-2 layers, the shared attention block every 6, a 2-layer tail)
and tinyllama-1.1b (22 layers, 8:1 GQA) at their published depth,
layout, head width, SSD state and heads, and vocabulary, with
``d_model`` cut to ``WIDTH`` (``d_ff`` and the head counts in proportion)
and a ``PROMPT``-token prompt, so the reference runs here.

Two bf16 computations of the same next-token logits are compared in each
package on the same params (the reference's ``init_params``, key 0):
  * ``consistency_*``: the reference's prefill/decode consistency check
    (``tests/test_model_math.py``: a decode of the last position after a
    prefill of the others, against the prefill of all), for ``chunked``
    and ``pallas`` attention;
  * ``chunked_vs_pallas``: the two attention paths' prefill logits.
Each gap is read against ``dev``, the bf16 prefill's own deviation from
the fp32 prefill on the same params (``pallas``). In both packages every
gap stays within ``dev`` plus one bf16 ulp of max|logits| (the logits'
own rounding: a gap of a few ulps is quantized): what remains between two
bf16 paths is bf16 rounding noise, which at depth exceeds the bounds the
reference set on its 2-layer ``reduced()`` configs as the width grows
(the reference's own zamba2 chunked-vs-pallas gap exceeds 2e-2 of
max|logits| from width 512). ``chip_smoke.py`` holds the card's
full-width bf16 gaps to the same limit (``LM_ARCH_BF16_GAP_RATIO``). The
fp32 gaps vanish in both.

Run as a script to read other cuts (slow; the reference on the CPU):
``PYTHONPATH=src:tests python tests/test_torch_arch_depth.py 512 512
[arch]``.
"""
import dataclasses
import sys

import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax
import jax.numpy as jnp
import numpy as np
import torch

ARCH = "zamba2-1.2b"
ARCHS = (ARCH, "tinyllama-1.1b")
WIDTH, PROMPT = 256, 256
RATIO = 1.0          # a bf16 gap over dev; chip_smoke.py's limit
TRACK = 1.5          # the port's gap over the reference's
F32_TOL = 1e-4       # an fp32 gap over max|logits|
GAPS = ("consistency_chunked", "consistency_pallas", "chunked_vs_pallas")


def depth_cfgs(width, arch=ARCH):
    """(jax cfg, jax dims, port cfg, port dims): the arch at its published
    depth, layout, head width, SSM and vocabulary, ``d_model`` cut."""
    from repro.configs import get_arch as j_get
    from repro.nn.dims import compute_dims as j_dims
    from repro_torch.configs import get_arch as t_get
    from repro_torch.nn.dims import compute_dims as t_dims

    def cut(c):
        heads = width // (c.head_dim or c.d_model // c.num_heads)
        return dataclasses.replace(
            c, d_model=width, num_heads=heads,
            num_kv_heads=max(1, heads * c.num_kv_heads // c.num_heads),
            d_ff=width * c.d_ff // c.d_model)
    jc, tc = cut(j_get(arch)), cut(t_get(arch))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, j_dims(jc), tc, t_dims(tc)


def _gaps(run, bf16, f32):
    """The gaps of one package from ``run(params, impl) -> (prefill of
    all, decode of the last)`` logits as fp32 numpy."""
    r = {(d, impl): run(p, impl) for d, p in (("bf16", bf16), ("f32", f32))
         for impl in ("chunked", "pallas")}
    diff = lambda a, b: float(np.max(np.abs(a - b)))
    out = {"max_logits": float(np.max(np.abs(r["f32", "pallas"][0]))),
           "dev": diff(*(r[d, "pallas"][0] for d in ("bf16", "f32"))),
           "chunked_vs_pallas": diff(r["bf16", "chunked"][0],
                                     r["bf16", "pallas"][0])}
    for impl in ("chunked", "pallas"):
        out[f"consistency_{impl}"] = diff(*r["bf16", impl])
        out[f"f32_consistency_{impl}"] = diff(*r["f32", impl])
        full = r["bf16", impl][0]
        out[f"beyond_{impl}"] = float(np.mean(
            np.abs(full - r["bf16", impl][1]) > 0.15 + 0.05 * np.abs(full)))
    out["f32_chunked_vs_pallas"] = diff(r["f32", "chunked"][0],
                                        r["f32", "pallas"][0])
    return out


def measure(width=WIDTH, prompt=PROMPT, arch=ARCH, batch=1) -> dict:
    """``{"ref"|"port": gaps}`` on the same params and prompt tokens; the
    reference's steps through ``jax.jit``, its flash in interpret mode."""
    from repro.launch import steps as j_steps
    from repro.nn import model as j_model
    from repro_torch.convert import tree_from_numpy
    from repro_torch.launch import steps as t_steps
    from repro_torch.nn.params import tree_map
    jc, jd, tc, td = depth_cfgs(width, arch)
    jp = j_model.init_params(jc, jd, jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (batch, prompt)).astype(np.int32)
    s = prompt

    def ref(p, impl):
        pre = jax.jit(j_steps.make_prefill_step(
            jc, jd, j_steps.StepOptions(attn_impl=impl), s_max=s))
        t = jnp.asarray(toks)
        full, _ = pre(p, {"tokens": t})
        _, cache = pre(p, {"tokens": t[:, :-1]})
        dec, _ = jax.jit(j_steps.make_decode_step(jc, jd))(
            p, cache, t[:, -1:], jnp.int32(s - 1))
        return tuple(np.asarray(a.astype(jnp.float32)) for a in (full, dec))

    def port(p, impl):
        pre = t_steps.make_prefill_step(
            tc, td, t_steps.StepOptions(attn_impl=impl), s_max=s)
        t = torch.from_numpy(toks).long()
        full, _ = pre(p, {"tokens": t})
        _, cache = pre(p, {"tokens": t[:, :-1]})
        dec, _ = t_steps.make_decode_step(tc, td)(p, cache, t[:, -1:], s - 1)
        return tuple(a.float().numpy() for a in (full, dec))

    return {"ref": _gaps(ref, jp, jax.tree.map(
                lambda a: a.astype(jnp.float32), jp)),
            "port": _gaps(port, tp, tree_map(lambda a: a.float(), tp))}


def _ulp(r) -> float:
    """One bf16 ulp of max|logits|."""
    return 2.0 ** (np.floor(np.log2(r["max_logits"])) - 7)


@pytest.fixture(scope="module", params=ARCHS)
def readings(request):
    return measure(arch=request.param)


@pytest.mark.parametrize("gap", GAPS)
@pytest.mark.parametrize("side", ["ref", "port"])
def test_bf16_gap_stays_within_bf16_noise(readings, side, gap):
    r = readings[side]
    assert r[gap] <= RATIO * r["dev"] + _ulp(r), (side, gap, r)


@pytest.mark.parametrize("gap", GAPS)
def test_port_bf16_gap_tracks_reference(readings, gap):
    ref = readings["ref"]
    assert readings["port"][gap] <= TRACK * ref[gap] + _ulp(ref), readings


@pytest.mark.parametrize("side", ["ref", "port"])
def test_fp32_gaps_vanish(readings, side):
    r = readings[side]
    for key in ("f32_consistency_chunked", "f32_consistency_pallas",
                "f32_chunked_vs_pallas"):
        assert r[key] <= F32_TOL * r["max_logits"], (side, key, r)


if __name__ == "__main__":
    w, p = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (
        WIDTH, PROMPT)
    arch = sys.argv[3] if len(sys.argv) > 3 else ARCH
    for side, r in measure(w, p, arch).items():
        print(f"{arch} d_model {w}, prompt {p}, {side}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in r.items())
              + "; gap / dev: " + ", ".join(
                  f"{g} {r[g] / r['dev']:.3f}" for g in GAPS))
