#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process:

    python3 bench/control.py --workload cnet.stream --seeds 1,2,3 \\
        --seconds 3

For each seed it runs the cell's own traffic for a short window on the
card, as ``bench/run.py`` does, and prints one JSON line with the
program's gaps against the int8 reference (the sound readings, the lower
ends of the limits) and the control's: the reference computed in int4,
the precision below the configuration's, in the program's place, on the
same sampled requests (the upper ends). The configuration's system
(``systems/<system>.py``) serves, compares and computes the control.
``--device cpu`` runs the program's plain kernels on the CPU, with
``--narrow`` at the CPU tests' widths.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import check, harness  # noqa: E402

# the widths the CPU tests serve at
NARROW = {
    "cnet_plus_scalar": {"build_args": {"input_shape": [32, 32, 2],
                                        "channels": [8, 8, 4], "dense": 12},
                         "pool_frames": 32},
    "vae_encoder": {"build_args": {"input_shape": [32, 64, 3]},
                    "pool_frames": 32},
}


def readings(manifest, cell, seed: int, seconds: float, device,
             overrides=None, traffic_overrides=None):
    """(program's gaps, control's gaps, requests checked) of one seed."""
    cfg = manifest.config(cell["config"])
    cfg.update(overrides or {})
    traffic = manifest.traffic(cell["traffic"])
    traffic.update(traffic_overrides or {})
    ref = harness.reference(cell["config"], manifest.root)
    served = harness.system(cfg, manifest.root)
    system = served.build(cfg, ref, traffic, seed, device)
    harness.settle()
    harness.LOOPS[traffic["loop"]](system, traffic, seconds, seed, None)
    harness.unsettle()
    reqs = sorted(system.reqs.values(), key=lambda r: r.rid)
    outputs = system.outputs()
    system.release()
    del system
    numbers, _ = served.compare(cfg, ref, seed, device, reqs, outputs)
    picked = check.sample(reqs, cfg["check"]["sample"], seed)
    ctl = served.control(cfg, ref, seed, device, picked)
    return ({k: v for k, (v, _) in numbers.items()}, ctl, len(picked))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--narrow", action="store_true")
    args = ap.parse_args(argv)
    manifest = harness.Manifest()
    cell = manifest.workload(args.workload)
    dev = torch.device(args.device)
    over = NARROW[cell["config"]] if args.narrow else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        prog, ctl, n = readings(manifest, cell, seed, args.seconds, dev, over)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "checked": n, "program": prog, "control": ctl,
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
