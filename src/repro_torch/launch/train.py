"""Training launcher (src/repro/launch/train.py).

Runs the train step under the StepGuard (async checkpoints, crash-resume,
straggler detection) on the card, unless ``--device cpu``. Params are the
port's seeded ``init_params`` (a ``torch.Generator`` seeded 0); the data
is the reference's step-seeded synthetic stream, so a resumed run sees the
batches an uninterrupted one would.

``--production-mesh`` (``--multi-pod``: with the pod axis) builds the
(data, model) = (16, 16) mesh, or (2, 16, 16), from the ``torchrun`` world
(``nccl`` on cards, one rank per card; ``gloo`` with ``--device cpu``),
shards params and optimizer state by ``launch/specs.py:
shardings_for_cell`` and feeds each step through ``data/pipeline.py:
host_shard``. A world of another size exits naming the ranks needed.
Checkpoints hold full arrays under the reference's leaf names, written by
rank 0, so a sharded run's checkpoint restores in a one-rank run and back.

As in the reference, a resumed run restores the newest committed
checkpoint and then runs ``--steps`` more steps from it.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT --device cpu
    torchrun --nproc-per-node 8 ... -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --production-mesh        # 256 ranks in all

``REPRO_CRASH_AT_STEP=N`` simulates a node failure entering step N: the
guard commits the last good state, then the error propagates.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import contextlib

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore)
from repro_torch.configs import SHAPES_BY_NAME, get_arch, reduced
from repro_torch.data.pipeline import (DataConfig, data_iterator, host_shard,
                                       local_slice)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, tp_degree
from repro_torch.launch.specs import shardings_for_cell
from repro_torch.launch.steps import StepOptions, TrainState, make_train_step
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import compute_dims
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel import sharding
from repro_torch.runtime.fault_tolerance import StepGuard, detect_stragglers


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    ap.add_argument("--metrics-out", default=None,
                    help="append each step's exact loss and grad norm to "
                         "this file as JSON lines")
    return ap


def to_device(batch: dict, device: torch.device,
              dtype: torch.dtype) -> dict:
    """A numpy batch as tensors on ``device``; frame embeddings in the
    params' ``dtype`` (the reference feeds fp32 frames to a bf16 model
    and lets jnp promote every product to fp32; torch's matmuls do not
    promote)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(dtype)
    return out


def world_mesh(multi_pod: bool, device: torch.device):
    """The production mesh over the ``torchrun`` world (started here from
    its environment unless a process group runs already). A world of
    another size exits naming the ranks the mesh needs."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=device.type)
    except ValueError as e:
        raise SystemExit(f"--production-mesh{' --multi-pod' * multi_pod}: "
                         f"{e} (start it under torchrun)") from None


class MeshCheckpointer:
    """Checkpoints of a sharded state in the one-rank format: every rank
    gathers each leaf whole (``full_tensor()``), rank 0 writes it under the
    reference's leaf names."""

    def __init__(self, inner: AsyncCheckpointer, writer: bool):
        self.inner, self.writer = inner, writer

    def save(self, step: int, tree) -> None:
        _, leaves = ckpt._flatten_with_names(tree)
        whole = ckpt._unflatten(tree, [sharding.full(x) for x in leaves])
        if self.writer:
            self.inner.save(step, whole)

    def wait(self) -> None:
        if self.writer:
            self.inner.wait()
        dist.barrier()


def restore_sharded(ckpt_dir: str, step: int, state):
    """:func:`restore` of a full checkpoint into ``state``'s layouts: each
    rank reads the arrays and keeps its block."""
    _, leaves = ckpt._flatten_with_names(state)
    whole = [torch.empty(x.shape, dtype=x.dtype, device="cpu")
             for x in leaves]
    got = ckpt._flatten_with_names(
        restore(ckpt_dir, step, ckpt._unflatten(state, whole)))[1]
    placed = [sharding.place(g, sharding.spec_of(x), sharding.current_mesh())
              if isinstance(x, sharding.DTensor) else g.to(x.device)
              for g, x in zip(got, leaves)]
    return ckpt._unflatten(state, placed)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    shape = SHAPES_BY_NAME[args.shape]
    mesh = world_mesh(args.multi_pod, device) if args.production_mesh \
        else None
    with (sharding.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        return _run(args, device, cfg, shape, mesh)


def _run(args, device, cfg, shape, mesh) -> int:
    """The run on ``mesh`` (installed by the caller), or on one device."""
    dims = compute_dims(cfg, tp=1 if mesh is None else tp_degree(mesh))
    writer = mesh is None or dist.get_rank() == 0

    optimizer = AdamW(lr=cosine_schedule(args.lr, warmup=20,
                                         total=max(args.steps, 100)))
    opts = StepOptions(microbatch=args.microbatch)
    train_step = make_train_step(cfg, dims, optimizer, opts)

    b = args.batch or shape.global_batch
    s = args.seq or shape.seq_len
    params = model_lib.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                   device)
    dtype = params["final_norm"].dtype
    if mesh is not None:
        cell = shardings_for_cell(cfg, dims, shape, mesh, optimizer)
        params = sharding.place_tree(params, cell["params"], mesh)
    state = TrainState(params, optimizer.init(params))

    def batches(first: int):
        if mesh is None:
            yield from data_iterator(cfg, dims, shape, DataConfig(),
                                     start_step=first, batch_override=b,
                                     seq_override=s)
            return
        index, count = sharding.coordinate(cell["inputs"]["labels"][0], mesh)
        step = first
        while True:
            yield local_slice(step, cfg, dims, shape, DataConfig(), index,
                              count, batch_override=b, seq_override=s)
            step += 1

    data = batches(0)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            if writer:
                print(f"[resume] restoring step {last} from {args.ckpt_dir}")
            state = (restore(args.ckpt_dir, last, state) if mesh is None
                     else restore_sharded(args.ckpt_dir, last, state))
            start = last
            data = batches(last)

    step_times = {}
    world = dist.get_world_size() if mesh is not None else 1

    def on_metrics(step, metrics):
        loss = float(sharding.full(metrics["loss"]))
        gn = float(sharding.full(metrics["grad_norm"]))
        if not writer:
            return
        if args.metrics_out:
            with open(args.metrics_out, "a") as f:
                f.write(json.dumps({"step": step, "loss": loss,
                                    "grad_norm": gn}) + "\n")
        if step % args.log_every == 0 or step == start + 1:
            dt = step_times.get("last", 0.0)
            print(f"step {step:6d}  loss {loss:.4f}  gnorm {gn:.2f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
        stragglers = detect_stragglers(
            {f"host{i}": step_times.get("last", 0.0) for i in range(world)})
        if stragglers:
            print(f"[straggler] {stragglers}")

    crash_at = int(os.environ.get("REPRO_CRASH_AT_STEP", "0")) or None
    steps_done = {"n": start}

    def timed_step(st, batch):
        if crash_at is not None and steps_done["n"] + 1 >= crash_at:
            # simulated node failure (examples/train_driver.py --crash-at);
            # the StepGuard commits the last good state before re-raising.
            raise RuntimeError(f"simulated node failure at step {crash_at}")
        t0 = time.perf_counter()
        if mesh is None:
            batch = to_device(batch, device, dtype)
        else:
            batch = host_shard(batch, mesh, cell["inputs"], device)
            if "embeds" in batch:
                batch["embeds"] = batch["embeds"].to(dtype)
        st, m = train_step(st, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_times["last"] = time.perf_counter() - t0
        steps_done["n"] += 1
        return st, m

    if args.ckpt_dir:
        saver = AsyncCheckpointer(args.ckpt_dir)
        if mesh is not None:
            saver = MeshCheckpointer(saver, writer)
        guard = StepGuard(saver, save_every=args.save_every)
        state, end = guard.run(state, timed_step, data, args.steps,
                               start_step=start, on_metrics=on_metrics)
    else:
        end = start
        for _ in range(args.steps):
            state, metrics = timed_step(state, next(data))
            end += 1
            on_metrics(end, metrics)
    if writer:
        print(f"[done] trained to step {end}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
