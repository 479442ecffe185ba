"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on a fake
process group (src/repro/launch/dryrun.py).

The reference lowers and compiles each cell on 512 fake host devices. The
port runs the same step functions the launcher runs, on a fake process
group of 256 or 512 ranks (``torch.testing``'s ``FakeStore``, backend
``"fake"``: collectives complete at once) under ``FakeTensorMode`` (no
tensor is allocated), in one CPU process, as rank 0 of the production
mesh. Per cell it records:

  * ``state_bytes``: this rank's params, optimizer state and cache, exact
    from the local shard shapes (in place of ``memory_analysis``), and
    ``peak_act_bytes``, the peak of live activations by ``MemTracker``;
  * ``flops``: this rank's matmul FLOPs (in place of ``cost_analysis``):
    ``FlopCounterMode``'s formulas on the local operands, and for a
    product DTensor runs, its local output times the contraction length
    each rank covers;
  * ``collectives``: wire bytes per kind, from the functional collectives
    the step calls (each result's bytes times the reference's
    ``WIRE_FACTOR``). On a CPU mesh DTensor moves a shard from one dim to
    another by all-gather and chunk (no all-to-all on the CPU), so those
    transposes count as all-gather; the port's explicit all-to-all (the
    MoE dispatch) counts as all-to-all.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single --ledger build/x.json

The ledger defaults to ``build/dryrun_ledger.json``; the reference's
``benchmarks/dryrun_ledger.json`` is its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_archs, get_arch, shapes_for
from repro_torch.launch.mesh import make_production_mesh, tp_degree
from repro_torch.launch.specs import (abstract_train_state, input_specs,
                                      shardings_for_cell)
from repro_torch.launch.steps import (StepOptions, TrainState,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import compute_dims
from repro_torch.nn.params import tree_leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (DTensor, local_shape,
                                           serving_rules, use_mesh)

LEDGER = Path(__file__).resolve().parents[3] / "build" / "dryrun_ledger.json"

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

# ring all-reduce moves ~2x the buffer; others ~1x
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# the functional collectives, by the reference's HLO collective names
FUNCOL_KIND = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_to_all_single": "all-to-all"}

_MATMULS = {torch.ops.aten.mm.default: (0, 1),        # (operand, K dim)
            torch.ops.aten.bmm.default: (0, 2),
            torch.ops.aten.addmm.default: (1, 1),
            torch.ops.aten.baddbmm.default: (1, 2)}


class RankCost(TorchDispatchMode):
    """This rank's matmul FLOPs and its collectives' wire bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._opname
        if func.namespace == "_c10d_functional":
            kind = FUNCOL_KIND.get(name)
            if kind is not None:
                b = out.numel() * out.element_size() * WIRE_FACTOR[kind]
                self.collectives[kind] = self.collectives.get(kind, 0.0) + b
            return out
        dt = any(isinstance(a, DTensor) for a in args)
        if dt and func in _MATMULS:
            arg, kdim = _MATMULS[func]
            partial = math.prod(
                out.device_mesh.size(i) for i, p in enumerate(out.placements)
                if p.is_partial())
            self.flops += (2 * out.to_local().numel()
                           * args[arg].shape[kdim] // partial)
        elif not dt and func._overloadpacket in flop_counter.flop_registry:
            self.flops += flop_counter.flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        return out


def fake_world(world: int) -> None:
    """(Re)start this process's default group as ``world`` fake ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_tree(tree, specs, mesh):
    """Shape-only DTensors: each leaf of ``tree`` (anything with ``shape``
    and ``dtype``) as this rank's block of an array laid out by its spec,
    on the ``meta`` device (nothing is allocated)."""
    if isinstance(tree, dict):
        return {k: fake_tree(v, specs[k], mesh) for k, v in tree.items()}
    shape = tuple(tree.shape)
    local = torch.empty(local_shape(shape, specs, mesh), dtype=tree.dtype,
                        device="meta")
    return sharding.from_blocks(local, specs, mesh, shape)


def local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size()
               if isinstance(x, DTensor) else x.numel() * x.element_size()
               for x in tree_leaves(tree))


def apply_overrides(cfg, overrides: Dict[str, Any]):
    """Config surgery for perf iterations (e.g. {'moe_impl': 'a2a'});
    ``layers`` (tests only) sets the depth."""
    if not overrides:
        return cfg
    if "moe_impl" in overrides and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         ep_impl=overrides["moe_impl"]))
    if overrides.get("kv8") and cfg.attends:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if "layers" in overrides:
        cfg = dataclasses.replace(cfg, num_layers=overrides["layers"])
    return cfg


def build_cell(cfg, dims, shape, mesh, opts: StepOptions,
               overrides: Dict[str, Any], rules):
    """(fn, args, state) of one full cell: ``fn(*args)`` is the step the
    launcher runs; ``state`` maps each kind of per-rank state to its
    tree."""
    optimizer = AdamW(lr=1e-4)
    sh = shardings_for_cell(cfg, dims, shape, mesh, optimizer, rules)
    inputs = fake_tree(input_specs(cfg, dims, shape), sh["inputs"], mesh)
    params_abs, _ = abstract_train_state(cfg, dims, optimizer)
    if shape.kind == "train":
        params = fake_tree(params_abs, sh["params"], mesh)
        state = TrainState(params, optimizer.init(params))
        fn = make_train_step(cfg, dims, optimizer, opts)
        return fn, (state, inputs), {"params": params,
                                     "opt": state.opt._asdict()}
    if shape.kind == "prefill":
        params = fake_tree(params_abs, sh["params"], mesh)
        fn = make_prefill_step(cfg, dims, opts, s_max=shape.seq_len)
        return fn, (params, inputs), {"params": params}
    cache_abs = model_lib.abstract_cache(cfg, dims, shape.global_batch,
                                         shape.seq_len)
    cache = fake_tree(cache_abs, sh["cache"], mesh)
    base = make_decode_step(cfg, dims)
    if overrides.get("quant") == "w8":
        # int8 weight storage for the memory-bound decode
        from repro_torch.core import lm_quant
        from repro_torch.launch.specs import state_axes
        q_abs = lm_quant.abstract_quantized(params_abs)
        q_axes = lm_quant.quantized_axes(params_abs, state_axes(cfg, dims)[0])
        params = fake_tree(q_abs, sharding.tree_specs(q_abs, q_axes, mesh,
                                                      rules), mesh)

        def fn(qp, c, tok, pos):
            return base(lm_quant.dequantize_params(qp), c, tok, pos)
    else:
        params = fake_tree(params_abs, sh["params"], mesh)
        fn = base
    return fn, (params, cache, inputs["token"], shape.seq_len - 1), \
        {"params": params, "cache": cache}


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             opts: StepOptions = StepOptions(), granularity: str = "full",
             overrides: Dict[str, Any] = None,
             track_memory: bool = True) -> Dict[str, Any]:
    """One cell's record; ``track_memory=False`` skips ``MemTracker``
    (about half the run's time) and records no peak."""
    overrides = overrides or {}
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape), "granularity": granularity,
    }
    if overrides:
        rec["overrides"] = dict(overrides)
    cfg = apply_overrides(get_arch(arch_id), overrides)
    dims = compute_dims(cfg, tp=tp_degree(mesh))
    shape = {s.name: s for s in shapes_for(cfg)}[shape_name]
    rules = serving_rules(mesh) if overrides.get("serving") else None
    t0 = time.time()
    with use_mesh(mesh, rules):
        if granularity == "full":
            fn, args, state = build_cell(cfg, dims, shape, mesh, opts,
                                         overrides, rules)
            rec["state_bytes"] = {k: local_bytes(v) for k, v in state.items()}
        else:  # 'group' | 'tail' — one group (or tail block) alone
            from repro_torch.launch.group_probe import (build_group_cell,
                                                        build_tail_cell)
            if granularity == "group":
                fn, args = build_group_cell(
                    cfg, dims, shape, mesh, fake_tree,
                    attn_impl=opts.attn_impl, remat=opts.remat,
                    remat_policy=opts.remat_policy,
                    quant=overrides.get("quant"))
            else:
                fn, args = build_tail_cell(cfg, dims, shape, mesh, fake_tree)
        rec["build_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        cost = RankCost()
        mem = _tracker() if track_memory else contextlib.nullcontext()
        with mem, cost:
            fn(*args)
        rec["run_s"] = round(time.time() - t1, 1)
        rec["flops"] = cost.flops
        coll = dict(cost.collectives)
        coll["total"] = sum(coll.values())
        rec["collectives"] = coll
        if track_memory:
            rec["peak_act_bytes"] = _peak_act(mem)
    return rec


def _tracker():
    from torch.distributed._tools.mem_tracker import MemTracker
    return MemTracker()


def _peak_act(mem) -> int:
    """The step's peak of live activations on this rank (``MemTracker``'s
    ``ACT`` category). Its ``TEMP`` category also counts the whole-array
    fakes DTensor's shape inference makes, which no rank allocates, so it
    is left out."""
    peak = mem.get_tracker_snapshot("peak")
    return int(sum(v.get(k, 0) for v in peak.values() for k in v
                   if str(k).endswith("ACT")))


def load_ledger(path: Path) -> Dict[str, Any]:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_ledger(ledger: Dict[str, Any], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(ledger, indent=1, sort_keys=True))
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--tag", default="baseline", help="ledger namespace")
    ap.add_argument("--granularity", default="full",
                    choices=["full", "group", "tail"],
                    help="'group'/'tail' run ONE group (or hybrid tail "
                         "block) step: the roofline's per-group probes")
    ap.add_argument("--moe-impl", default=None, choices=[None, "scatter", "a2a"],
                    help="override MoE dispatch")
    ap.add_argument("--quant", default=None, choices=[None, "w8"],
                    help="int8 weight storage for decode cells")
    ap.add_argument("--serving", action="store_true",
                    help="serving sharding: replicate weights over data")
    ap.add_argument("--kv8", action="store_true", help="int8 KV cache")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"],
                    help="activation-checkpoint policy")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="gradient-accumulation chunks")
    ap.add_argument("--ledger", default=str(LEDGER),
                    help="the JSON ledger this run updates")
    args = ap.parse_args(argv)

    overrides = {}
    if args.moe_impl:
        overrides["moe_impl"] = args.moe_impl
    if args.quant:
        overrides["quant"] = args.quant
    if args.serving:
        overrides["serving"] = True
    if args.kv8:
        overrides["kv8"] = True

    path = Path(args.ledger)
    ledger = load_ledger(path)
    failures = []
    archs = [args.arch] if args.arch else list(all_archs())
    gran = args.granularity
    tag = args.tag if gran == "full" else f"{args.tag}-{gran}"
    for arch_id in archs:
        cfg = get_arch(arch_id)
        if gran == "tail" and cfg.family != "hybrid":
            continue
        for shape in shapes_for(cfg):
            if args.shape and shape.name != args.shape:
                continue
            for mesh_kind in ("single", "multi"):
                if args.mesh and mesh_kind != args.mesh:
                    continue
                key = f"{tag}/{arch_id}/{shape.name}/{mesh_kind}"
                if key in ledger and not args.force \
                        and ledger[key].get("status") == "ok":
                    print(f"[skip] {key}")
                    continue
                print(f"[cell] {key} ...", flush=True)
                try:
                    rec = run_cell(arch_id, shape.name, mesh_kind,
                                   opts=StepOptions(
                                       remat_policy=args.remat_policy,
                                       microbatch=args.microbatch),
                                   granularity=gran, overrides=overrides)
                    rec["status"] = "ok"
                    print(f"  ok run={rec['run_s']}s "
                          f"flops={rec['flops'] / 1e12:.2f}T "
                          f"coll={rec['collectives']['total'] / 1e9:.2f}GB",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — ledger records failures
                    rec = {"arch": arch_id, "shape": shape.name,
                           "mesh": mesh_kind, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append(key)
                    print(f"  FAIL {type(e).__name__}: {e}", flush=True)
                ledger[key] = rec
                save_ledger(ledger, path)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\n{len(failures)} failures" if failures else "\nall cells ok")
    for f in failures:
        print("  ", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
