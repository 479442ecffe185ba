"""One run of one cell: build the served system from the seed, drive its
traffic for the window, read the metrics, check the answers.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (``configs/<config>.json``) and plain reference
(``reference/<config>.py``), the served system the configuration names
(``systems/<system>.py``), the traffic's parameters
(``traffic/<traffic>.json``), one reader per metric
(``metrics/<metric>.py``) and the operation counts per layer kind
(``counts/<op>.py``). The loops drive the system through ``start()``,
``submit()`` and ``stop()`` as a deployment drives it, and time each
answer on the host when the system reports it ready.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench import loads

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


# ---------------------------------------------------------------------------
# The manifest and the files it names
# ---------------------------------------------------------------------------


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = root
        with open(root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def workload(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    cfg = json.load(f)
                if cfg["name"] != name:
                    raise ValueError(f"{c['file']} names {cfg['name']!r}")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        with open(self.root / "bench" / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, kind: str) -> List[Dict[str, Any]]:
        """``kind`` is ``end_to_end`` or ``per_layer``: the entries that
        the cell reports."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell in m["workloads"]]


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # registered first, as an import would, so that its dataclasses resolve
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config: str, root: Path = ROOT):
    """The configuration's plain reference, ``reference/<config>.py``."""
    return _load_file(root / "bench" / "reference" / f"{config}.py",
                      "bench_reference_" + config.replace(".", "_"))


def system(cfg: Dict[str, Any], root: Path = ROOT):
    """The module of the system the configuration names,
    ``systems/<system>.py`` (the contract is ``systems/__init__.py``)."""
    name = cfg["system"]
    return _load_file(root / "bench" / "systems" / f"{name}.py",
                      "bench_system_" + name.replace(".", "_"))


def metric_reader(name: str):
    return _load_file(BENCH / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_"))


def counts(op: str):
    return importlib.import_module(f"bench.counts.{op}")


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card (``peaks.json``), None if unknown."""
    with open(BENCH / "peaks.json") as f:
        return json.load(f).get(kind)


def handwritten_kernels() -> List[Dict[str, Any]]:
    """The port's hand-written kernel families (``kernels/<family>.json``):
    the name fragments that identify each in a trace, and the layers it
    runs."""
    out = []
    for path in sorted((BENCH / "kernels").glob("*.json")):
        with open(path) as f:
            out.append(json.load(f))
    return out


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------


def stream_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit generator seeds derived from ``seed``."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    return [int(s) >> 1 for s in ss.generate_state(n, dtype=np.uint64)]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


# ---------------------------------------------------------------------------
# A request
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Req:
    rid: int
    frame: int
    due: float
    submitted: float
    answered: Optional[float] = None
    dispatched: Optional[float] = None
    rec_idx: Optional[int] = None
    row: Optional[int] = None
    rung: Optional[int] = None
    tail: bool = False


# ---------------------------------------------------------------------------
# The two loops
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    energy_j: Optional[float]
    lateness: Optional[Dict[str, float]] = None
    in_flight_at_close: Optional[int] = None
    gave_up_at: Optional[float] = None


def _wait_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def closed_loop(system, traffic, seconds: float, seed: int,
                energy, tracer=None) -> Window:
    """``outstanding`` frames in flight: each answer inside the window
    submits the next frame at once. At the close the recorder's buffer
    ends with a ragged tail of frames (a count drawn from the seed), which
    ``stop()`` flushes as one padded batch."""
    counter = {"k": 0}
    lock = threading.Lock()
    t1_box = {"t1": math.inf}

    def next_frame(t: float) -> None:
        with lock:
            k = counter["k"]
            counter["k"] += 1
        system.submit(k, t)

    def on_answers(n: int, t: float) -> None:
        if t < t1_box["t1"]:
            for _ in range(n):
                next_frame(t)

    system.on_answers = on_answers
    system.start()
    if energy is not None:
        energy.begin()
    t0 = time.monotonic()
    t1_box["t1"] = t0 + seconds
    for _ in range(traffic["outstanding"]):
        next_frame(t0)
    _trace_stretch(tracer, traffic, t0, seconds)
    _wait_until(t0 + seconds)
    t1 = time.monotonic()
    if tracer is not None:
        tracer.mark_end()
    energy_j = energy.end() if energy is not None else None
    in_flight = sum(1 for r in list(system.reqs.values())
                    if r.answered is None)
    lo, hi = traffic["tail"]
    n_tail = int(np.random.default_rng(stream_seeds(seed, 4)[3]).integers(
        lo, hi + 1))
    for _ in range(n_tail):
        with lock:
            k = counter["k"]
            counter["k"] += 1
        system.submit(k, time.monotonic(), tail=True)
    if tracer is not None:
        tracer.request_stop()
        tracer.done.wait(timeout=30)
    system.stop()
    system.on_answers = None
    return Window(t0, t1, energy_j, in_flight_at_close=in_flight)


def open_loop(system, traffic, seconds: float, seed: int,
              energy, tracer=None) -> Window:
    """Poisson arrivals at the traffic's fixed rate, each request timed
    from when it was due. Arrivals go on after the close until every
    request due in the window has its answer (or the deadline has passed
    for the last of them), since a frame is answered only when later
    dispatches retire it."""
    rate = float(traffic["rate_hz"])
    grace = system.deadline_s + 1.0
    offsets = loads.window_arrivals(rate, seconds, grace, seed)
    stop = threading.Event()
    t0_box: Dict[str, float] = {}
    ready = threading.Event()

    def gen():
        ready.wait()
        t0 = t0_box["t0"]
        for k, off in enumerate(offsets):
            due = t0 + float(off)
            while True:
                d = due - time.monotonic()
                if d <= 0 or stop.is_set():
                    break
                time.sleep(min(d, 0.02))
            if stop.is_set():
                return
            system.submit(k, due)

    thread = threading.Thread(target=gen, name="bench-arrivals", daemon=True)
    thread.start()
    system.start()
    if energy is not None:
        energy.begin()
    t0 = time.monotonic()
    t0_box["t0"] = t0
    ready.set()
    _trace_stretch(tracer, traffic, t0, seconds)
    _wait_until(t0 + seconds)
    t1 = time.monotonic()
    if tracer is not None:
        tracer.mark_end()
    energy_j = energy.end() if energy is not None else None
    give_up = t1 + grace
    while time.monotonic() < give_up:
        due_in = [r for r in list(system.reqs.values()) if r.due < t1]
        if all(r.answered is not None for r in due_in):
            break
        time.sleep(0.005)
    gave_up = time.monotonic()
    stop.set()
    thread.join(timeout=30)
    if tracer is not None:
        tracer.request_stop()
        tracer.done.wait(timeout=30)
    system.stop()
    lat = np.array([r.submitted - r.due for r in list(system.reqs.values())
                    if r.due < t1] or [0.0])
    return Window(t0, t1, energy_j,
                  lateness={"max_ms": float(lat.max() * 1e3),
                            "p99_ms": float(np.percentile(lat, 99) * 1e3),
                            "median_ms": float(np.median(lat) * 1e3)},
                  gave_up_at=gave_up)


def _trace_stretch(tracer, traffic, t0: float, seconds: float) -> None:
    """A traced run profiles the window's last ``trace_seconds``."""
    if tracer is None:
        return
    start = t0 + max(seconds - traffic["trace_seconds"], 0.0)

    def arm():
        _wait_until(start)
        tracer.request_start()

    threading.Thread(target=arm, name="bench-trace-arm", daemon=True).start()


LOOPS = {"closed": closed_loop, "open": open_loop}


def settle() -> None:
    """End of set-up: collect once and move every object set-up made into
    the collector's permanent generation, as a long-running server does
    after loading, so that a full collection inside the window walks only
    what the window itself allocates."""
    gc.collect()
    gc.freeze()


def unsettle() -> None:
    """After the window: set-up's objects are the collector's again."""
    gc.unfreeze()


def per_second(reqs, window: Window) -> List[int]:
    """Answers in each whole second of the window (the tail excluded)."""
    n = int(window.t1 - window.t0)
    counts = [0] * n
    for r in reqs:
        if r.answered is not None and not r.tail:
            k = int(r.answered - window.t0)
            if 0 <= k < n:
                counts[k] += 1
    return counts


# ---------------------------------------------------------------------------
# What a metric reader sees
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    cell: Dict[str, Any]
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seconds: float
    setup_s: float
    window: Window
    reqs: List[Req]
    deadline_s: float
    layers: List[Dict[str, Any]]
    peaks: Optional[Dict[str, float]]
    trace: Any = None               # devtrace.TraceData in a traced run
    trace_from: Optional[float] = None  # host time the trace began

    @property
    def answered_in_window(self) -> List[Req]:
        w = self.window
        return [r for r in self.reqs if r.answered is not None
                and w.t0 <= r.answered <= w.t1 and not r.tail]

    @property
    def due_in_window(self) -> List[Req]:
        w = self.window
        return [r for r in self.reqs if w.t0 <= r.due < w.t1 and not r.tail]

    def untraced(self, reqs: List[Req]) -> List[Req]:
        """The requests due before a traced stretch began (all of them in
        an untraced run)."""
        if self.trace_from is None:
            return reqs
        return [r for r in reqs if r.due < self.trace_from]

    def latency_s(self, r: Req) -> float:
        """Due time to answer; a request never answered counts the wait
        until the run gave up on it."""
        end = r.answered if r.answered is not None else self.window.gave_up_at
        return end - r.due
