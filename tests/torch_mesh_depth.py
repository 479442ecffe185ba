"""bf16 noise of a meshed forward at depth, in the reference and in the
port: zamba2-1.2b at its published depth and layout (38 Mamba-2 layers,
the shared attention block every 6, the tail), SSD state and heads, head
width and vocabulary, ``d_model`` cut as ``tests/test_torch_arch_depth.py``
cuts it, on a ``(1, 4)`` (data, model) mesh — the layout of
``chip_smoke.py``'s full-width ``mesh_path`` check.

For each width and each package, on the same params (the reference's
``init_params``, key 0) and prompt tokens, the train-mode logits of four
runs: meshed and unmeshed, bf16 and fp32. Printed: ``gap``, the bf16
meshed logits' max deviation from the bf16 unmeshed ones; ``dev``, the
bf16 unmeshed logits' max deviation from the fp32 unmeshed ones (the
bf16 noise ``chip_smoke.py`` holds each full-width gap to); the fp32
meshed-vs-unmeshed gap over max|logits|; and whether ``gap`` is within
the 0.15 that the reference's meshed test sets on its 2-layer configs.

The reference runs in this process on 4 forced host devices with
``Auto`` axes (jax 0.9's default ``Explicit`` axes fail its
``constrain``); the port in 4 gloo ranks. Slow (the reference on the
CPU); not collected by pytest::

    PYTHONPATH=src:tests python tests/torch_mesh_depth.py [WIDTH ...]
"""
import os
import sys

ARCH = "zamba2-1.2b"
MESH = (1, 4)                      # (data, model)
BATCH, PROMPT = 2, 256
WIDTHS = (256, 512)


def cut(width):
    """(jax cfg, jax dims, port cfg, port dims) at ``width``, padded for
    the mesh's model axis."""
    from repro.nn.dims import compute_dims as j_dims
    from repro_torch.nn.dims import compute_dims as t_dims
    from test_torch_arch_depth import depth_cfgs
    jc, _, tc, _ = depth_cfgs(width, ARCH)
    return jc, j_dims(jc, tp=MESH[1]), tc, t_dims(tc, tp=MESH[1])


def _tokens(vocab):
    import numpy as np
    return np.random.default_rng(0).integers(
        0, vocab, (BATCH, PROMPT)).astype(np.int32)


def reference(width):
    """(params as numpy, {(meshed, dtype): logits}) of the reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.nn import model as model_lib
    from repro.parallel.sharding import use_mesh
    jc, jd, _, _ = cut(width)
    params = model_lib.init_params(jc, jd, jax.random.PRNGKey(0))
    x = jnp.asarray(_tokens(jc.vocab_size))
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, dtype in (("bf16", None), ("f32", jnp.float32)):
        p = params if dtype is None else jax.tree.map(
            lambda a: a.astype(dtype), params)
        fwd = jax.jit(lambda p, t: model_lib.forward(
            p, t, jc, jd, mode="train", remat=False))
        out[False, name] = np.asarray(fwd(p, x).astype(jnp.float32))
        with use_mesh(mesh):
            out[True, name] = np.asarray(jax.jit(lambda p, t: model_lib.forward(
                p, t, jc, jd, mode="train", remat=False))(p, x).astype(
                    jnp.float32))
    return jax.tree.map(np.asarray, params), out


def port_rank(rank, width, params):
    """The port's four runs on the mesh's ranks (rank 0 also unmeshed)."""
    import torch
    from repro_torch.convert import tree_from_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.nn import model as model_lib
    from repro_torch.nn.params import tree_map
    from repro_torch.parallel import sharding as sh
    _, _, tc, td = cut(width)
    mesh = make_test_mesh(*MESH)
    tp = tree_from_numpy(params, "cpu")
    x = torch.from_numpy(_tokens(tc.vocab_size)).long()
    out = {}
    with torch.no_grad():
        for name, dtype in (("bf16", None), ("f32", torch.float32)):
            p = tp if dtype is None else tree_map(lambda a: a.to(dtype), tp)
            if rank == 0:
                out[False, name] = model_lib.forward(
                    p, x, tc, td, mode="train", remat=False).float().numpy()
            with sh.use_mesh(mesh):
                dp = sh.shard_tree(p, model_lib.param_axes(tc, td), mesh)
                dx = sh.layout(x, sh.spec_for(x.shape, ("batch", "seq"), mesh),
                               mesh)
                out[True, name] = sh.full(model_lib.forward(
                    dp, dx, tc, td, mode="train", remat=False)).float().numpy()
    return out if rank == 0 else None


def readings(runs):
    import numpy as np
    diff = lambda a, b: float(np.max(np.abs(a - b)))
    m = float(np.max(np.abs(runs[False, "f32"])))
    return {"max_logits": m,
            "gap": diff(runs[True, "bf16"], runs[False, "bf16"]),
            "dev": diff(runs[False, "bf16"], runs[False, "f32"]),
            "f32_rel": diff(runs[True, "f32"], runs[False, "f32"]) / m,
            "ulp": 2.0 ** (np.floor(np.log2(m)) - 7)}


def main(widths):
    from repro_torch.parallel import transport
    for width in widths:
        params, ref = reference(width)
        port = transport.spawn(port_rank, MESH[0] * MESH[1], width, params,
                               timeout=3000)[0]
        for side, runs in (("ref", ref), ("port", port)):
            r = readings(runs)
            print(f"{ARCH} d_model {width}, B={BATCH} x {PROMPT}, mesh "
                  f"{MESH}, {side}: max|logits| {r['max_logits']:.4g}, bf16 "
                  f"meshed vs unmeshed {r['gap']:.4g} ("
                  + ("within" if r["gap"] < 0.15 else "NOT within")
                  + f" 0.15), bf16 vs fp32 unmeshed (dev) {r['dev']:.4g}, "
                  f"gap / dev {r['gap'] / r['dev']:.3f}, gap / (dev + one "
                  f"bf16 ulp) {r['gap'] / (r['dev'] + r['ulp']):.3f}; fp32 "
                  f"meshed vs unmeshed {r['f32_rel']:.3g} of max|logits|",
                  flush=True)


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main([int(a) for a in sys.argv[1:]] or WIDTHS)
