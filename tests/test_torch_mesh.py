"""The port's large-model stack on a mesh of 8 gloo ranks, held against
the reference's meshed runs (``src/repro/parallel/``, the
sequence-parallel hooks in ``nn/``, the a2a MoE dispatch, GPipe), against
its own one-rank runs (the sharded train step, prefill and decode), and
end to end through ``launch/train.py --production-mesh``.

The reference runs in ONE subprocess for the file, on 8 forced host
devices with a ``(2, 4)`` mesh of ``Auto`` axes (jax 0.9's ``make_mesh``
defaults to ``Explicit`` axes, on which the reference's ``constrain``
fails; nothing of the reference changes). The port runs in ONE spawn of 8
ranks (``torch_mesh_cases.mesh_rank``), one intra-op thread each, while
the reference's subprocess runs. Both compute on the same numpy-drawn
parameters and inputs; the tests compare the saved outputs:

* fp32 meshed logits: the port's against the reference's, 1e-5 of
  max|logits| (the fp32 arch bound);
* bf16 meshed logits against the port's unmeshed ones, within the
  reference test's 0.15 (the gaps are printed beside the reference's own
  5.9e-3 / 4.9e-3 / 1.3e-2);
* a meshed prefill and decode steps against unmeshed ones (fp32, 1e-5);
* the vocab-parallel embedding lookup against the whole table's rows
  (exact) and its table gradient (1e-6);
* the a2a dispatch against the scatter and against the reference's a2a,
  2e-5 (the reference test's case); GPipe against the sequential stack and
  the reference's ``pipeline_forward``, 1e-5;
* the sharded train step (reduced dense and MoE with the a2a dispatch,
  fp32, microbatch 2) against the one-rank step, which
  ``tests/test_torch_train_step.py`` holds to the reference, at that
  file's bounds: the loss 1e-5 relative, every gradient leaf within 1e-4 of the
  leaf's max|g|, the updated params 1e-5 wherever |g| exceeds 100 eps
  (below it Adam's first update ``g / (|g| + eps)`` amplifies last-bit
  gradient differences);
* ``data/pipeline.py``'s ``host_shard`` / ``local_slice`` against the
  global batch and the reference's ``local_slice``;
* ``--production-mesh`` on a (4, 2) test mesh: trains, checkpoints full
  arrays, and a one-rank run resumes them.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on the GPU machine

import jax

import torch_mesh_cases as C
from repro.configs import SHAPES_BY_NAME as J_SHAPES
from repro.configs import get_arch as j_arch
from repro.configs import reduced as j_reduced
from repro.data import pipeline as j_pipeline
from repro.nn.dims import compute_dims as j_dims
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.launch import train as tl
from repro_torch.parallel import transport
from repro_torch.parallel.pipeline_parallel import bubble_fraction

EPS_G = 100 * 1e-8
SMOKE = ["--arch", "qwen1.5-0.5b", "--smoke", "--batch", "4", "--seq", "16",
         "--device", "cpu", "--log-every", "1", "--save-every", "1"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_GAPS = {"tinyllama-1.1b": 5.9e-3, "llama4-scout-17b-a16e": 4.9e-3,
            "zamba2-1.2b": 1.3e-2}

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path[:0] = [{src!r}, {tests!r}]
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    import torch_mesh_cases as C
    from repro.configs import get_arch, reduced
    from repro.nn import model as model_lib, moe as moe_mod
    from repro.nn.dims import compute_dims
    from repro.parallel.pipeline_parallel import pipeline_forward
    from repro.parallel.sharding import use_mesh

    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh(C.MESH, ("data", "model"), axis_types=auto)
    out = {{}}
    for arch in C.FWD_ARCHS:
        cfg = reduced(get_arch(arch))
        dims = compute_dims(cfg, tp=C.MESH[1])
        params = jax.tree.map(jnp.asarray,
                              C.numpy_tree(model_lib.model_spec(cfg, dims)))
        x = jnp.asarray(C.model_inputs(cfg.frontend, cfg.vocab_size,
                                       dims.d_model))
        with use_mesh(mesh):
            out["fwd/" + arch] = np.asarray(jax.jit(
                lambda p, t: model_lib.forward(p, t, cfg, dims, mode="train",
                                               remat=False))(params, x))
    cfg0 = reduced(get_arch("llama4-scout-17b-a16e"))
    dims = compute_dims(cfg0, tp=C.MESH[1])
    cfg = C.a2a_cfg(cfg0)
    params = jax.tree.map(jnp.asarray, C.numpy_tree(moe_mod.moe_spec(cfg, dims)))
    with use_mesh(mesh):
        out["a2a"] = np.asarray(jax.jit(lambda p, x: moe_mod.moe_ffn(
            p, x, cfg, dims))(params, jnp.asarray(C.a2a_x(dims.d_model))))
    pmesh = jax.make_mesh(C.MESH, ("data", "stage"), axis_types=auto)
    pp, x = C.pipe_case()
    out["pipe"] = np.asarray(jax.jit(lambda p, x: pipeline_forward(
        p, x, lambda lp, h: jnp.tanh(h @ lp["w"] + lp["b"]), pmesh,
        extra_specs=P("data", None, None)))(
            jax.tree.map(jnp.asarray, pp), jnp.asarray(x)))
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, port outputs, the launcher's directory): the
    reference's subprocess runs while the port's ranks do."""
    d = tmp_path_factory.mktemp("mesh")
    path = str(d / "ref.npz")
    code = REFERENCE.format(src=os.path.join(ROOT, "src"),
                            tests=os.path.join(ROOT, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    launch = SMOKE + ["--steps", "2", "--ckpt-dir", str(d / "ckpt"),
                      "--production-mesh", "--metrics-out",
                      str(d / "sharded.jsonl")]
    try:
        port = transport.spawn(C.mesh_rank, 8, launch, timeout=600)[0]
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log
    with np.load(path) as z:
        return dict(z), port, d


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", C.FWD_ARCHS)
def test_meshed_fp32_forward_matches_the_reference_meshed(runs, arch):
    ref, port, _ = runs
    assert port[f"fwd/{arch}/f32/mesh"].shape == ref[f"fwd/{arch}"].shape
    rel = _rel(port[f"fwd/{arch}/f32/mesh"], ref[f"fwd/{arch}"])
    print(f"{arch}: fp32 meshed vs the reference's meshed, rel {rel:.3g}")
    assert rel < 1e-5


@pytest.mark.parametrize("arch", C.FWD_ARCHS)
def test_meshed_bf16_forward_matches_unmeshed(runs, arch):
    _, port, _ = runs
    got, want = port[f"fwd/{arch}/bf16/mesh"], port[f"fwd/{arch}/bf16/plain"]
    gap = float(np.abs(got - want).max())
    print(f"{arch}: bf16 meshed vs unmeshed max|d| {gap:.3g} "
          f"(the reference's own: {REF_GAPS[arch]})")
    assert np.isfinite(got).all() and gap < 0.15


@pytest.mark.parametrize("arch", C.DECODE_ARCHS)
def test_meshed_prefill_and_decode_match_unmeshed(runs, arch):
    """Prefill, then decode steps writing the sharded cache in place."""
    _, port, _ = runs
    got, want = port[f"serve/{arch}/mesh"], port[f"serve/{arch}/plain"]
    assert got.shape == (C.STEPS + 1, C.B, want.shape[-1])
    for step in range(C.STEPS + 1):
        assert _rel(got[step], want[step]) < 1e-5, step


def test_a2a_dispatch_matches_scatter(runs):
    _, port, _ = runs
    assert np.abs(port["a2a/mesh"] - port["scatter/mesh"]).max() < 2e-5
    assert np.abs(port["a2a/mesh"] - port["a2a/plain"]).max() < 2e-5


def test_a2a_dispatch_matches_the_reference_a2a(runs):
    ref, port, _ = runs
    gap = float(np.abs(port["a2a/mesh"] - ref["a2a"]).max())
    print(f"a2a: the port's against the reference's max|d| {gap:.3g}")
    assert gap < 2e-5


@pytest.mark.parametrize("case", [c[0] for c in C.LOOKUP_CASES])
def test_vocab_parallel_lookup_is_the_whole_tables(runs, case):
    """The meshed embedding lookup gives the table's rows exactly (one rank
    holds each row; the others add zeros), and the table's gradient sums
    the cotangent's rows per token id."""
    _, port, _ = runs
    _, v, shape = next(c for c in C.LOOKUP_CASES if c[0] == case)
    table, tokens, cot = C.lookup_case(v, shape)
    np.testing.assert_array_equal(port[f"lookup/{case}"], table[tokens])
    want = np.zeros_like(table)
    np.add.at(want, tokens.reshape(-1), cot.reshape(-1, table.shape[1]))
    np.testing.assert_allclose(port[f"lookup/{case}/grad"], want, rtol=1e-6,
                               atol=1e-6)


def test_pipeline_matches_sequential_and_the_reference(runs):
    ref, port, _ = runs
    params, x = C.pipe_case()
    want = x
    for i in range(C.PIPE["L"]):
        want = np.tanh(want @ params["w"][i] + params["b"][i])
    np.testing.assert_allclose(port["pipe/mesh"], want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port["pipe/mesh"], ref["pipe"], atol=1e-5,
                               rtol=1e-5)
    assert abs(bubble_fraction(4, 6) - 1 / 3) < 1e-12


# ---------------------------------------------------------------------------
# training on the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_sharded_loss_and_grad_norm_match_one_rank(runs, arch):
    _, port, _ = runs
    got, want = port[f"{arch}/mesh"], port[f"{arch}/plain"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-4 * abs(want["grad_norm"])


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_sharded_grads_match_one_rank(runs, arch):
    _, port, _ = runs
    got, want = port[f"{arch}/mesh"], port[f"{arch}/plain"]
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-30, i


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_sharded_update_matches_one_rank(runs, arch):
    _, port, _ = runs
    got, want = port[f"{arch}/mesh"], port[f"{arch}/plain"]
    for i, (p, w, g) in enumerate(zip(got["params"], want["params"],
                                      want["grads"])):
        sure = np.abs(g) > EPS_G
        assert np.abs(p - w)[sure].max(initial=0) <= 1e-5, i


def test_host_shard_assembles_the_global_batch(runs):
    """The ranks' rows assemble, bit-equal, into the step's global batch,
    and each rank holds only its block."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.data.pipeline import synthetic_batch
    hs = runs[1]["host_shard"]
    cfg, dims = C._train_cfg(C.TRAIN_ARCHS[0])
    want = synthetic_batch(3, cfg, dims, SHAPES_BY_NAME["train_4k"])
    assert set(hs["global"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(hs["global"][k], v)
        b, s = v.shape
        assert hs["local_shape"][k] == (b // C.MESH[0], s // C.MESH[1])


def test_local_slice_is_the_references_for_the_process(runs, monkeypatch):
    """Rank 0's rows are the reference's ``local_slice`` for its process
    index among the holders of distinct row blocks."""
    hs = runs[1]["host_shard"]
    monkeypatch.setattr(jax, "process_index", lambda: hs["index"])
    monkeypatch.setattr(jax, "process_count", lambda: hs["count"])
    cfg = j_reduced(j_arch(C.TRAIN_ARCHS[0]))
    want = j_pipeline.local_slice(3, cfg, j_dims(cfg, tp=C.MESH[1]),
                                  J_SHAPES["train_4k"])
    assert hs["count"] == C.MESH[0]
    for k, v in want.items():
        np.testing.assert_array_equal(hs["rows"][k], v)


# ---------------------------------------------------------------------------
# the launcher on the mesh
# ---------------------------------------------------------------------------


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def test_sharded_launcher_trains_and_checkpoints(runs):
    _, port, d = runs
    assert port["launcher_rc"] == 0
    assert latest_step(str(d / "ckpt")) == 2
    assert sorted(_losses(d / "sharded.jsonl")) == [1, 2]   # rank 0 alone


def test_one_rank_resumes_the_sharded_checkpoint(runs, capsys):
    _, _, d = runs
    ckpt = str(d / "ckpt")
    resumed = str(d / "resumed.jsonl")
    assert tl.main(SMOKE + ["--steps", "2", "--ckpt-dir", ckpt,
                            "--metrics-out", resumed]) == 0
    out = capsys.readouterr().out
    assert f"[resume] restoring step 2 from {ckpt}" in out
    assert "[done] trained to step 4" in out
    assert latest_step(ckpt) == 4
    # the sharded steps' losses are the one-rank launcher's (bf16 params)
    straight = str(d / "straight.jsonl")
    assert tl.main(SMOKE + ["--steps", "2", "--metrics-out", straight]) == 0
    got, want = _losses(d / "sharded.jsonl"), _losses(straight)
    for step in (1, 2):
        assert abs(got[step] - want[step]) <= 2e-2 * abs(want[step]), step
    assert sorted(_losses(resumed)) == [3, 4]
