#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` on one card.

    python3 bench/run.py --workload cnet.stream --seed 7 --seconds 20 \\
        --trace 0

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiled
stretch of the window. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
in a traced run ``breakdown``, and last ``check``, the numbers compared
beside their limits); the last lines of standard error repeat the
numbers compared. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import check, devtrace, energy, harness  # noqa: E402


def _say(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(harness.FORBIDDEN))


def run_cell(manifest, cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, energy_source=None,
             overrides=None, traffic_overrides=None):
    """One run; returns the result object. ``overrides`` and
    ``traffic_overrides`` replace keys of the configuration and the
    traffic (smaller widths and rates in the CPU tests), ``energy_source``
    stands in for the card's counter where there is no card."""
    t_start = T_START if t_start is None else t_start
    cfg = manifest.config(cell["config"])
    cfg.update(overrides or {})
    traffic = manifest.traffic(cell["traffic"])
    traffic.update(traffic_overrides or {})
    ref = harness.reference(cell["config"], manifest.root)
    served = harness.system(cfg, manifest.root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        kind = torch.cuda.get_device_name(0)
        props = torch.cuda.get_device_properties(0)
        uuid = getattr(props, "uuid", None)
        src = energy_source or energy.open_source(
            None if uuid is None else f"GPU-{uuid}")
        torch.cuda.reset_peak_memory_stats()
    else:
        kind, src = "cpu", energy_source
    try:
        return _run(manifest, cell, cfg, traffic, ref, served, dev, on_card,
                    kind, src, seed, seconds, trace, t_start)
    finally:
        if src is not None and energy_source is None:
            src.close()


def _run(manifest, cell, cfg, traffic, ref, served, dev, on_card, kind, src,
         seed, seconds, trace, t_start):
    limit = src.power_limit_w() if src is not None else None
    _say(f"device {kind}, {torch.cuda.device_count() if on_card else 0} "
         f"card(s) visible, {cell['chips']} used, power limit "
         f"{limit if limit is not None else 'not read'} W")
    _say(f"energy source {getattr(src, 'name', 'none')}")
    peaks = harness.peaks(kind)

    system = served.build(cfg, ref, traffic, seed, dev)
    tracer = None
    if trace:
        if on_card:
            devtrace.warm_profiler()
        tracer = devtrace.Tracer(system)
    harness.settle()
    window = harness.LOOPS[traffic["loop"]](system, traffic, seconds, seed,
                                            src, tracer)
    harness.unsettle()
    if window.lateness is not None:
        _say("arrivals late by max {max_ms:.3f} ms, p99 {p99_ms:.3f} ms, "
             "median {median_ms:.3f} ms".format(**window.lateness))
    if window.in_flight_at_close is not None:
        _say(f"{window.in_flight_at_close} requests in flight at the close "
             f"(neither attempted nor failed)")
    _say("answers per second of the window: "
         + " ".join(str(n) for n in harness.per_second(system.reqs.values(),
                                                       window)))
    peak_bytes = (torch.cuda.max_memory_allocated() if on_card else 0)

    reqs = sorted(system.reqs.values(), key=lambda r: r.rid)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"] if on_card else 0,
                   "memory_peak_bytes": int(peak_bytes)}
    run = harness.Run(cell, cfg, traffic, seconds, window.t0 - t_start,
                      window, reqs, cfg["deadline_s"], ref.layers(cfg), peaks)
    if tracer is not None and tracer.done.is_set() and tracer.ns_end:
        run.trace = tracer.data()
        run.trace_from = tracer.t_start
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.wall_s
    attempted = (run.answered_in_window if traffic["loop"] == "closed"
                 else run.due_in_window)
    failed = sum(1 for r in attempted
                 if r.answered is None or r.answered - r.due > run.deadline_s)

    outputs = system.outputs()
    system.release()
    del system, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, demoted = served.compare(cfg, ref, seed, dev, reqs, outputs)
    # a layer the demotion gate kept in fp32 runs at fp32 in the plan
    run.layers = [dict(x, precision="fp32") if x["name"] in demoted else x
                  for x in run.layers]
    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics(cell["name"], kind_key):
        v = harness.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": check.passed(numbers), "attempted": len(attempted),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = devtrace.breakdown(run.trace)
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = harness.Manifest()
    cell = manifest.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(manifest, cell, args.seed, args.seconds,
                      bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"modules that may not load in a run: {found}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
