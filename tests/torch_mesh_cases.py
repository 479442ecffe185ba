"""The meshed cases of the port's mesh tests, without JAX: the inputs and
parameters both packages compute on (drawn from numpy seeds, leaf by leaf
in sorted-key order, so the reference's tree and the port's hold the same
values), and the bodies the gloo ranks run (``parallel/transport.py:
spawn``). The reference side of each case is a script the test files run
in a subprocess; it imports this module for the same draws.
"""
import contextlib
import dataclasses

import numpy as np

FWD_ARCHS = ("tinyllama-1.1b", "llama4-scout-17b-a16e", "zamba2-1.2b")
DECODE_ARCHS = ("tinyllama-1.1b", "zamba2-1.2b")
MESH = (2, 4)                         # (data, model)
B, S = 4, 32                          # the meshed forward's batch
PREFILL, STEPS = 24, 4                # meshed prefill, then decode steps
A2A_X = (4, 16)                       # the a2a case's tokens (B, S)
PIPE = dict(L=8, D=16, n_micro=6, mb=2, S=4)
# the embedding lookup: (case, vocab, token shape). 64 rows split over
# 'model' (a seq of 8 reduce-scattered onto it; a decode step and a seq of
# 6 all-reduced); 62 rows cannot split, so each rank keeps them whole
LOOKUP_CASES = (("seq", 64, (4, 8)), ("decode", 64, (4, 1)),
                ("ragged", 64, (4, 6)), ("whole", 62, (4, 8)))


def numpy_tree(spec_tree, seed: int = 0):
    """A param tree drawn by each spec's init from a numpy seed, fp32 (a
    normal leaf: a standard normal clipped to [-2, 2] times the spec's
    scale). ``spec_tree``: either package's ``model_spec`` (nested dicts
    of specs with ``shape``, ``init``, ``scale``)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if t.init == "zeros":
            return np.zeros(t.shape, np.float32)
        if t.init == "ones":
            return np.ones(t.shape, np.float32)
        return (np.clip(rng.standard_normal(t.shape), -2, 2)
                * t.scale).astype(np.float32)
    return walk(spec_tree)


def model_inputs(frontend: str, vocab: int, d_model: int, b: int = B,
                 s: int = S, seed: int = 1) -> np.ndarray:
    """Token ids [b, s], or frame embeddings [b, s, d_model] (fp32)."""
    rng = np.random.default_rng(seed)
    if frontend == "text":
        return rng.integers(0, vocab, (b, s)).astype(np.int32)
    return rng.standard_normal((b, s, d_model)).astype(np.float32)


def a2a_cfg(cfg):
    """The reference test's a2a case: 4 experts, capacity factor 8."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=4, capacity_factor=8.0, ep_impl="a2a"))


def a2a_x(d_model: int) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(
        (*A2A_X, d_model)).astype(np.float32)


def lookup_case(v: int, shape):
    """(table [v, 8], token ids of ``shape``, a cotangent of the rows)."""
    g = np.random.default_rng(5)
    return (g.standard_normal((v, 8), dtype=np.float32),
            g.integers(0, v, shape),
            g.standard_normal((*shape, 8), dtype=np.float32))


def pipe_case():
    """(params {"w": [L, D, D], "b": [L, D]}, x [n_micro, mb, S, D])."""
    p = PIPE
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((p["L"], p["D"], p["D"]))
                    * p["D"] ** -0.5).astype(np.float32),
              "b": (rng.standard_normal((p["L"], p["D"])) * 0.1
                    ).astype(np.float32)}
    x = rng.standard_normal((p["n_micro"], p["mb"], p["S"], p["D"])
                            ).astype(np.float32)
    return params, x


# ---------------------------------------------------------------------------
# rank bodies (the port, on gloo ranks)
# ---------------------------------------------------------------------------


def _port_case(arch: str, dtype):
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.nn import model as model_lib
    from repro_torch.nn.dims import compute_dims
    from repro_torch.nn.params import tree_map
    cfg = reduced(get_arch(arch))
    dims = compute_dims(cfg, tp=MESH[1])
    params = tree_map(lambda a: torch.from_numpy(a).to(dtype),
                      numpy_tree(model_lib.model_spec(cfg, dims)))
    x = torch.from_numpy(model_inputs(cfg.frontend, cfg.vocab_size,
                                      dims.d_model))
    x = x.long() if cfg.frontend == "text" else x.to(dtype)
    return cfg, dims, params, x


def _axes(x):
    return ("batch", "seq") if x.ndim == 2 else ("batch", "seq", None)


def forward_rank(rank: int) -> dict:
    """Every meshed case of ``tests/test_torch_mesh.py`` on a (2, 4) mesh;
    rank 0 also runs the unmeshed port. Returns fp32 numpy arrays."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.nn import model as model_lib
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn.params import build_axes, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.pipeline_parallel import pipeline_forward
    mesh = make_test_mesh(*MESH)
    out = {}

    def both(key, fn, *args):
        with torch.no_grad():
            if rank == 0:
                out[f"{key}/plain"] = fn(*args, meshed=False)
            out[f"{key}/mesh"] = fn(*args, meshed=True)

    def fwd(cfg, dims, params, x, meshed):
        if not meshed:
            return model_lib.forward(params, x, cfg, dims, mode="train",
                                     remat=False).float().numpy()
        with sh.use_mesh(mesh):
            p = sh.shard_tree(params, model_lib.param_axes(cfg, dims), mesh)
            t = sh.layout(x, sh.spec_for(x.shape, _axes(x), mesh), mesh)
            y = model_lib.forward(p, t, cfg, dims, mode="train", remat=False)
            return sh.full(y).float().numpy()

    for arch in FWD_ARCHS:
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            both(f"fwd/{arch}/{name}", fwd, *_port_case(arch, dtype))

    def serve(cfg, dims, params, x, meshed):
        """Prefill PREFILL positions, then STEPS decode steps fed the next
        inputs: the next-token logits of each."""
        pre = steps.make_prefill_step(cfg, dims, s_max=PREFILL + STEPS)
        dec = steps.make_decode_step(cfg, dims)
        key = "tokens" if cfg.frontend == "text" else "embeds"
        ctx = sh.use_mesh(mesh) if meshed else contextlib.nullcontext()
        with ctx:
            if meshed:
                params = sh.shard_tree(params, model_lib.param_axes(cfg, dims),
                                       mesh)
            xs = x[:, :PREFILL]
            if meshed:
                xs = sh.layout(xs, sh.spec_for(xs.shape, _axes(xs), mesh),
                               mesh)
            logits, cache = pre(params, {key: xs})
            res = [sh.full(logits).float().numpy()]
            for i in range(STEPS):
                t = x[:, PREFILL + i:PREFILL + i + 1]
                if meshed:
                    ax = ("batch", None) if t.ndim == 2 else ("batch", None,
                                                              None)
                    t = sh.layout(t, sh.spec_for(t.shape, ax, mesh), mesh)
                logits, cache = dec(params, cache, t, PREFILL + i)
                res.append(sh.full(logits).float().numpy())
        return np.stack(res)

    for arch in DECODE_ARCHS:
        both(f"serve/{arch}", serve, *_port_case(arch, torch.float32))

    # the a2a dispatch against the scatter (the reference test's case)
    cfg, dims, _, _ = _port_case("llama4-scout-17b-a16e", torch.float32)
    cfg = a2a_cfg(cfg)
    cfg_s = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ep_impl="scatter"))
    spec = moe_mod.moe_spec(cfg, dims)
    mp = tree_map(torch.from_numpy, numpy_tree(spec))
    x = torch.from_numpy(a2a_x(dims.d_model))
    with torch.no_grad(), sh.use_mesh(mesh):
        p = sh.shard_tree(mp, build_axes(spec), mesh)
        t = sh.layout(x, sh.spec_for(x.shape, ("batch", "seq", None), mesh),
                      mesh)
        out["a2a/mesh"] = sh.full(moe_mod.moe_ffn(p, t, cfg, dims)).numpy()
        out["scatter/mesh"] = sh.full(
            moe_mod.moe_ffn(p, t, cfg_s, dims)).numpy()
    if rank == 0:
        with torch.no_grad():
            out["a2a/plain"] = moe_mod.moe_ffn(mp, x, cfg, dims).numpy()

    # the vocab-parallel embedding lookup and its table gradient
    from repro_torch.parallel.sharding import vocab_lookup
    for name, v, shape in LOOKUP_CASES:
        table, tokens, cot = (torch.from_numpy(a) for a in lookup_case(v, shape))
        with sh.use_mesh(mesh):
            t = sh.layout(table, sh.spec_for(table.shape, ("vocab", "fsdp"),
                                             mesh), mesh).requires_grad_(True)
            i = sh.layout(tokens, sh.spec_for(tokens.shape, ("batch", "seq"),
                                              mesh), mesh)
            y = vocab_lookup(t, i)
            (y * sh.as_dtensor(cot, mesh)).sum().backward()
            out[f"lookup/{name}"] = sh.full(y).detach().numpy()
            out[f"lookup/{name}/grad"] = sh.full(t.grad).numpy()

    # GPipe over (data 2, stage 4) against the sequential stack
    pipe = make_mesh(MESH, ("data", "stage"))
    params, x = pipe_case()
    params = {k: torch.from_numpy(v) for k, v in params.items()}

    def block(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])
    with torch.no_grad():
        got = pipeline_forward(params, torch.from_numpy(x), block, pipe,
                               extra_specs=("data", None, None))
    out["pipe/mesh"] = sh.full(got).numpy()
    return out if rank == 0 else None


TRAIN_ARCHS = ("tinyllama-1.1b", "llama4-scout-17b-a16e")
TRAIN_B, TRAIN_S, MICRO = 4, 32, 2


def _train_cfg(arch: str):
    """A reduced config for the train cases; the MoE one takes the a2a
    dispatch (the reference test's case: no token dropped on either
    dispatch, so the meshed a2a and the one-rank scatter agree)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.nn.dims import compute_dims
    cfg = reduced(get_arch(arch))
    if cfg.moe is not None:
        cfg = a2a_cfg(cfg)
    return cfg, compute_dims(cfg, tp=MESH[1])


def train_batch(vocab: int, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
            for k in ("tokens", "labels")}


def train_rank(rank: int) -> dict:
    """One fp32 train step (microbatch 2) and the full-batch gradients of
    each train case on the (2, 4) mesh, and on rank 0 without one; and
    ``host_shard`` / ``local_slice`` at ``train_4k``'s global batch."""
    import torch
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import batch_axes
    from repro_torch.nn import model as model_lib
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh
    mesh = make_test_mesh(*MESH)
    out = {}

    def run(cfg, dims, meshed):
        params = tree_map(torch.from_numpy,
                          numpy_tree(model_lib.model_spec(cfg, dims)))
        batch = {k: torch.from_numpy(v).long()
                 for k, v in train_batch(cfg.vocab_size).items()}
        opt = AdamW(lr=1e-3)
        step = steps.make_train_step(cfg, dims, opt,
                                     steps.StepOptions(microbatch=MICRO))
        loss_fn = steps.make_loss_fn(cfg, dims, steps.StepOptions())
        if meshed:
            params = sh.shard_tree(params, model_lib.param_axes(cfg, dims),
                                   mesh)
            batch = {k: sh.layout(v, sh.spec_for(v.shape, ("batch", "seq"),
                                                 mesh), mesh)
                     for k, v in batch.items()}
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        grads = torch.autograd.grad(loss_fn(leaves, batch),
                                    tree_leaves(leaves))
        state, m = step(steps.TrainState(params, opt.init(params)), batch)
        return {"grads": [sh.full(g).numpy() for g in grads],
                "loss": float(sh.full(m["loss"])),
                "grad_norm": float(sh.full(m["grad_norm"])),
                "params": [sh.full(p).detach().numpy()
                           for p in tree_leaves(state.params)]}

    for arch in TRAIN_ARCHS:
        cfg, dims = _train_cfg(arch)
        if rank == 0:
            out[f"{arch}/plain"] = run(cfg, dims, False)
        with sh.use_mesh(mesh):
            out[f"{arch}/mesh"] = run(cfg, dims, True)

    # host_shard: this rank's rows, assembled into the global batch
    cfg, dims = _train_cfg(TRAIN_ARCHS[0])
    shape = SHAPES_BY_NAME["train_4k"]
    specs = {k: sh.spec_for((shape.global_batch, shape.seq_len), ax, mesh)
             for k, ax in batch_axes(cfg, shape).items()}
    index, count = sh.coordinate(specs["labels"][0], mesh)
    rows = pipeline.local_slice(3, cfg, dims, shape, index=index, count=count)
    glob = pipeline.host_shard(rows, mesh, specs)
    out["host_shard"] = {"index": index, "count": count,
                         "rows": rows,
                         "global": {k: sh.full(v).numpy()
                                    for k, v in glob.items()},
                         "local_shape": {k: tuple(v.to_local().shape)
                                         for k, v in glob.items()}}
    return out


LAUNCH_MESH = (4, 2)                  # the launcher's (data, model) mesh


def launcher(argv: list) -> int:
    """``launch/train.py`` with ``--production-mesh`` on a (4, 2) test
    mesh of the spawn's 8 ranks (the production mesh needs 256; model 2
    pads the reduced config as one rank does, so its checkpoint restores
    there)."""
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_test_mesh
    tl.make_production_mesh = (
        lambda multi_pod=False, device_type=None:
        make_test_mesh(*LAUNCH_MESH, device_type=device_type))
    return tl.main(argv)


def mesh_rank(rank: int, launch_argv: list) -> dict:
    """Every meshed case of ``tests/test_torch_mesh.py`` in one spawn of
    8 ranks: the forward cases, the train cases, then the launcher."""
    out = forward_rank(rank)
    out_train = train_rank(rank)
    rc = launcher(launch_argv)
    if rank != 0:
        return None
    out.update(out_train)
    out["launcher_rc"] = rc
    return out
