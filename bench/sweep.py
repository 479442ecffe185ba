#!/usr/bin/env python3
"""Find the highest rate an open-loop cell's system sustains: one
set-up, then one open-loop window per offered rate, in one process.

    python3 bench/sweep.py --workload cnet.cadence --rates 200,400,800 \\
        --seconds 8 --seed 3

Prints one JSON line per rate: requests due in the window, the rate
answered inside it, latency quantiles from the due time, the queue left
at the close, and how late the arrivals ran. The knee is the highest
rate whose answered rate keeps up with the offered one and whose latency
does not grow with the window; a cell runs below it (PERF.md says how
far).
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    m = harness.Manifest()
    cell = m.workload(args.workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    ref = harness.reference(cell["config"])
    system = harness.system(cfg).build(cfg, ref, traffic, args.seed,
                                       torch.device("cuda"))
    harness.settle()
    for rate in (float(r) for r in args.rates.split(",")):
        system.reqs = {}
        w = harness.open_loop(system, dict(traffic, rate_hz=rate),
                              args.seconds, args.seed, None)
        due = [r for r in system.reqs.values() if w.t0 <= r.due < w.t1]
        done = [r for r in due if r.answered is not None]
        in_win = [r for r in done if r.answered <= w.t1]
        lat = np.array([r.answered - r.due for r in done]) * 1e3
        half = [r.answered - r.due for r in done
                if r.due >= w.t0 + args.seconds / 2]
        first = [r.answered - r.due for r in done
                 if r.due < w.t0 + args.seconds / 2]
        print(json.dumps({
            "rate_hz": rate, "due": len(due),
            "answered_per_s": len(in_win) / args.seconds,
            "unanswered_at_close": len(due) - len(in_win),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()),
            "p95_first_half_ms": float(np.percentile(first, 95) * 1e3),
            "p95_second_half_ms": float(np.percentile(half, 95) * 1e3),
            "late_p99_ms": w.lateness["p99_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
