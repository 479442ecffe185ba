"""Training launcher (src/repro/launch/train.py).

Runs the train step under the StepGuard (async checkpoints, crash-resume,
straggler detection) on one device: the card, unless ``--device cpu``.
Params are the port's seeded ``init_params`` (a ``torch.Generator``
seeded 0); the data is the reference's step-seeded synthetic stream, so
a resumed run sees the batches an uninterrupted one would.

As in the reference, a resumed run restores the newest committed
checkpoint and then runs ``--steps`` more steps from it.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir CKPT --device cpu

``REPRO_CRASH_AT_STEP=N`` simulates a node failure entering step N: the
guard commits the last good state, then the error propagates.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore)
from repro_torch.configs import SHAPES_BY_NAME, get_arch, reduced
from repro_torch.data.pipeline import DataConfig, data_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import StepOptions, TrainState, make_train_step
from repro_torch.nn import model as model_lib
from repro_torch.nn.dims import compute_dims
from repro_torch.optim.adamw import AdamW, cosine_schedule
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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise SystemExit("--production-mesh/--multi-pod need a device mesh: "
                         "the port's multi-device slice (ROADMAP item 11 "
                         "(c)) is not ported yet")
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    shape = SHAPES_BY_NAME[args.shape]
    dims = compute_dims(cfg, tp=1)

    optimizer = AdamW(lr=cosine_schedule(args.lr, warmup=20,
                                         total=max(args.steps, 100)))
    opts = StepOptions(microbatch=args.microbatch)
    train_step = make_train_step(cfg, dims, optimizer, opts)

    b = args.batch or shape.global_batch
    s = args.seq or shape.seq_len
    params = model_lib.init_params(cfg, dims, torch.Generator().manual_seed(0),
                                   device)
    state = TrainState(params, optimizer.init(params))
    dtype = params["final_norm"].dtype
    data = data_iterator(cfg, dims, shape, DataConfig(),
                         batch_override=b, seq_override=s)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[resume] restoring step {last} from {args.ckpt_dir}")
            state = restore(args.ckpt_dir, last, state)
            start = last
            data = data_iterator(cfg, dims, shape, DataConfig(),
                                 start_step=last,
                                 batch_override=b, seq_override=s)

    step_times = {}

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        gn = float(metrics["grad_norm"])
        if args.metrics_out:
            with open(args.metrics_out, "a") as f:
                f.write(json.dumps({"step": step, "loss": loss,
                                    "grad_norm": gn}) + "\n")
        if step % args.log_every == 0 or step == start + 1:
            dt = step_times.get("last", 0.0)
            print(f"step {step:6d}  loss {loss:.4f}  gnorm {gn:.2f}  "
                  f"{dt*1e3:.0f} ms/step", flush=True)
        stragglers = detect_stragglers({"host0": step_times.get("last", 0.0)})
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
        st, m = train_step(st, to_device(batch, device, dtype))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_times["last"] = time.perf_counter() - t0
        steps_done["n"] += 1
        return st, m

    if args.ckpt_dir:
        guard = StepGuard(AsyncCheckpointer(args.ckpt_dir),
                          save_every=args.save_every)
        state, end = guard.run(state, timed_step, data, args.steps,
                               start_step=start, on_metrics=on_metrics)
    else:
        end = start
        for _ in range(args.steps):
            state, metrics = timed_step(state, next(data))
            end += 1
            on_metrics(end, metrics)
    print(f"[done] trained to step {end}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
