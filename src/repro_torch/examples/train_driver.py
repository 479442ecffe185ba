"""Training driver with checkpoint/restart — fault tolerance demonstrated
(examples/train_driver.py, on the port).

Trains a small llama-family LM (same code path as the full configs) on
the synthetic task, kills itself at a configurable step to simulate a
node failure, then the rerun resumes from the last committed async
checkpoint. Shows: loss goes down, resume is exact (same data order via
the step-seeded pipeline), and the StepGuard's straggler detection.

Run (the second command resumes the first's checkpoints)::

  PYTHONPATH=src python -m repro_torch.examples.train_driver --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_driver --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_driver --steps 200 \
      --crash-at 120

Delegates to ``repro_torch.launch.train`` — this file just picks small
sizes. Runs on the card unless given ``--device cpu``; the checkpoints go
under the temporary directory unless ``--ckpt-dir`` names another.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as train_launcher


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)

    if args.crash_at is not None:
        os.environ["REPRO_CRASH_AT_STEP"] = str(args.crash_at)

    argv = ["--arch", args.arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", args.ckpt_dir, "--save-every", "25",
            "--log-every", "20"]
    if args.device:
        argv += ["--device", args.device]
    return train_launcher.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
