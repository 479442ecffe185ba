"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel bit-exact against its plain PyTorch version at the
shapes the served model gives it and times both, then serves
cnet_plus_scalar at full published width on the int8 ``accel`` backend
through the continuous-batching scheduler, checks from the launch counters
that the served path ran the kernels, and holds the served outputs
bit-exact against the port's CPU engine (the plain versions) sharing the
same weights and calibration. Any failed phase makes the exit code
non-zero; the last line is a JSON verdict only on success.

Needs a CUDA card and the repository's ``src/`` beside this file. Imports
nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# H100 SXM data-sheet peaks: HBM3 rate, dense int8 and fp32 (non-tensor) rates
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_FP32_OPS_S = 67e12

BATCH = 16
LADDER_TOP = 16
N_REQUESTS = 48

FAILURES = []


def phase(name):
    """Run one phase; record (never raise) its failure."""
    def deco(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            except Exception:
                traceback.print_exc(file=sys.stdout)
                print(f"   FAILED: {name}", flush=True)
                FAILURES.append(name)
                return None
            print(f"   ok ({time.perf_counter() - t0:.1f} s)", flush=True)
            return out
        return run
    return deco


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call;
    ``flush`` (a large buffer) is rewritten before every call so each call
    finds the L2 cache cold, as a served layer does."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def library_ms(torch, xl, wl, flush):
    """torch._int_mm's time, trying the row-major then the column-major
    weight layout; None (with the reason) if it takes neither."""
    for w in (wl, wl.t().contiguous().t()):
        try:
            return device_ms(torch, lambda: torch._int_mm(xl, w), 50, flush)
        except RuntimeError as e:
            reason = str(e).splitlines()[0]
    print(f"   torch._int_mm refused the shape: {reason}")
    return None


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def exact(torch, got, want) -> float:
    """Max |got - want|; raises unless the two are bit-identical."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"not bit-exact: max |diff| {err}")
    return err


@phase("build: nvcc -gencode arch=compute_90a,code=sm_90a, one process per "
       "source")
def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"   built {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s wall")
    for name, b in built.items():
        src = b.path.name
        print(f"   {name}: {src} ({b.seconds:.1f} s)")
        for line in b.ptxas.splitlines():
            if "Used" in line or "Function properties" in line \
                    or "Compiling entry" in line:
                print(f"     {line.strip()}")
    return built


def _kernel_record(name, source, replaces, cases):
    """Sum one kernel's per-shape measurements into its JSON record."""
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0,
        "max_abs_err": max(c["err"] for c in cases),
        "ms": sum(c["ms"] for c in cases),
        "plain_ms": sum(c["plain_ms"] for c in cases),
        "bound_ms": sum(c["bound_ms"] for c in cases),
        "bound_by": max(cases, key=lambda c: c["bound_ms"])["bound_by"],
        "library_ms": (None if any(c["library_ms"] is None for c in cases)
                       else sum(c["library_ms"] for c in cases)),
    }


def _print_case(c):
    lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
    print(f"   {c['shape']}: ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
          f"library_ms={lib} bound_ms={c['bound_ms']:.5f} "
          f"({c['bound_by']}) max_abs_err={c['err']}")


@phase("int8_matmul vs plain (fc1 and head at B=16)")
def matmul_phase(torch, gen, flush):
    from repro_torch.kernels import int8_matmul as mm
    dev = "cuda"
    cases = []
    # (M, K, N, act, requant, bias): fc1 = dense+relu+requant, head = dense
    for m, k, n, act, rq in ((BATCH, 32769, 92, "relu", 0.0123456789),
                             (BATCH, 92, 1, None, None)):
        x = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        xs = (torch.rand(m, generator=gen) * 0.01 + 1e-3).to(dev)
        ws = (torch.rand(n, generator=gen) * 0.01 + 1e-3).to(dev)
        b = torch.randn(n, generator=gen).to(dev)
        out = mm.int8_matmul(x, w, xs, ws, b, act=act, requant_scale=rq)
        torch.cuda.synchronize()
        ref = mm.int8_matmul_plain(x, w, xs, ws, b, act, rq)
        err = exact(torch, out, ref)
        t = device_ms(torch, lambda: mm.int8_matmul(
            x, w, xs, ws, b, act=act, requant_scale=rq), 50, flush)
        tp = device_ms(torch, lambda: mm.int8_matmul_plain(
            x, w, xs, ws, b, act, rq), 10, flush)
        # torch._int_mm (int8 x int8 -> int32, matmul only, no epilogue)
        # needs M > 16 and K, N multiples of 8: time it on the shape
        # rounded up to what it accepts
        mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        xl = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
        wl = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
        xl[:m, :k], wl[:k, :n] = x, w
        tl = library_ms(torch, xl, wl, flush)
        out_bytes = m * n * (1 if rq is not None else 4)
        nbytes = m * k + k * n + 4 * (m + 2 * n) + out_bytes
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, PEAK_INT8_OPS_S)
        cases.append(dict(shape=f"[{m},{k}]x[{k},{n}] act={act} requant="
                          f"{rq is not None}", err=err, ms=t, plain_ms=tp,
                          library_ms=tl, bound_ms=bms, bound_by=by))
        _print_case(cases[-1])
    print("   library_ms: torch._int_mm on [17+,K8]x[K8,N8], the matmul only")
    return _kernel_record("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
                          "src/repro/kernels/int8_matmul.py:136", cases)


@phase("conv2d_int8 vs plain (conv0/1/2 at B=16)")
def conv_phase(torch, gen, flush):
    from repro_torch.kernels import conv2d as cv
    dev = "cuda"
    cases = []
    # (H, W, Cin, Cout, requant, int8 input from a requantizing producer)
    for h, w_, cin, cout, rq in ((256, 256, 2, 48, 0.02),
                                 (128, 128, 48, 48, 0.0163),
                                 (64, 64, 48, 32, None)):
        x = torch.randint(-127, 128, (BATCH, h, w_, cin), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                          dtype=torch.int8).to(dev)
        ws = (torch.rand(cout, generator=gen) * 0.01).to(dev)
        b = torch.randn(cout, generator=gen).to(dev)
        kw = dict(x_scale=0.00876, stride=1, padding="SAME", act="relu",
                  requant_scale=rq)
        out = cv.conv2d_int8(x, w, ws, b, **kw)
        torch.cuda.synchronize()
        ref = cv.conv2d_int8_plain(x, w, ws, b, **kw)
        err = exact(torch, out, ref)
        t = device_ms(torch, lambda: cv.conv2d_int8(x, w, ws, b, **kw), 30,
                      flush)
        tp = device_ms(torch, lambda: cv.conv2d_int8_plain(x, w, ws, b, **kw),
                       5, flush)
        out_bytes = BATCH * h * w_ * cout * (1 if rq is not None else 4)
        nbytes = x.numel() + w.numel() + 8 * cout + out_bytes
        ops = 2.0 * BATCH * h * w_ * cout * 9 * cin
        bms, by = bound_ms(nbytes, ops, PEAK_INT8_OPS_S)
        cases.append(dict(shape=f"[{BATCH},{h},{w_},{cin}]->{cout} requant="
                          f"{rq is not None}", err=err, ms=t, plain_ms=tp,
                          library_ms=None, bound_ms=bms, bound_by=by))
        _print_case(cases[-1])
        print(f"     dynamic shared memory per block: "
              f"{cv.smem_bytes(cin, cout, 3, 3, 1)} B")
    print("   library_ms: none (PyTorch has no int8 convolution on CUDA)")
    return _kernel_record("conv2d_int8", "src/repro_torch/csrc/conv2d_int8.cu",
                          "src/repro/kernels/conv2d.py:284", cases)


@phase("quantize_apply vs plain (the five CNet weight matrices)")
def quantize_phase(torch, gen, flush):
    from repro_torch.kernels import quantize as qz
    dev = "cuda"
    cases = []
    for m, n in ((18, 48), (432, 48), (432, 32), (32769, 92), (92, 1)):
        x = torch.randn((m, n), generator=gen).to(dev)
        scale = x.abs().amax(0) / 127.0 + 1e-12
        out = qz.quantize_apply(x, scale)
        torch.cuda.synchronize()
        err = exact(torch, out, qz.quantize_apply_plain(x, scale))
        t = device_ms(torch, lambda: qz.quantize_apply(x, scale), 50, flush)
        tp = device_ms(torch, lambda: qz.quantize_apply_plain(x, scale), 20,
                       flush)
        nbytes = 4 * m * n + 4 * n + m * n
        bms, by = bound_ms(nbytes, 3.0 * m * n, PEAK_FP32_OPS_S)
        cases.append(dict(shape=f"[{m},{n}]", err=err, ms=t, plain_ms=tp,
                          library_ms=None, bound_ms=bms, bound_by=by))
        _print_case(cases[-1])
    print("   library_ms: none")
    return _kernel_record("quantize_apply", "src/repro_torch/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:49", cases)


@phase("profile: device time by kernel over served B=16 dispatches")
def profile_phase(torch, engine, inputs):
    """Where one full-rung dispatch's device time goes (torch.profiler,
    CUDA activity), and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.pipeline import ServingPipeline
    pipe = ServingPipeline(engine, "accel", batch_size=BATCH)
    reqs = inputs[:BATCH]
    pipe.execute_batch(reqs)
    n = 5
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                pipe.execute_batch(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    except RuntimeError as e:        # the tracer itself, not the port
        print(f"   torch.profiler failed ({e}): not measured")
        return None
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    if not rows:
        print("   profiler recorded no device time: not measured")
        return None
    print(f"   {n} dispatches: wall {wall * 1e3:.3f} ms "
          f"({wall / n * 1e3:.3f} ms each), device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}")
    for dev_us, count, key in rows[:12]:
        print(f"   {dev_us / n / 1e3:9.4f} ms/dispatch  x{count // n:<3d} "
              f"{key[:70]}")
    return busy / n


@phase("main path: serve cnet_plus_scalar (full width) on accel through "
       "the scheduler")
def serve_phase(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parser().parse_args([
        "--mode", "space", "--model", "cnet_plus_scalar", "--backend",
        "accel", "--requests", str(N_REQUESTS), "--batch", str(LADDER_TOP)])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched, trace, engines = serve.build_scheduler(args)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched.serve_trace(trace)
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    tel = sched.telemetry()["cnet_plus_scalar"]
    print(sched.summary())
    n_disp = len(sched.dispatches)
    n_warm = 2 * len(serve.capped_ladder(LADDER_TOP))
    print(f"   setup (calibrate + warm-up) {setup:.2f} s; served "
          f"{tel.n_completed}/{N_REQUESTS} requests in {n_disp} dispatches, "
          f"wall {wall:.3f} s, p50 {tel.p50_latency_ms:.2f} ms, "
          f"p99 {tel.p99_latency_ms:.2f} ms")
    print(f"   launch counts: {counts}")
    assert tel.n_completed == N_REQUESTS, tel.n_completed
    assert counts["quantize_apply"] == 5, counts
    assert counts["conv2d_int8"] == 3 * (n_warm + n_disp), counts
    assert counts["int8_matmul"] == 2 * (n_warm + n_disp), counts
    # request ids are assigned in arrival order
    inputs = [r for _, _, r in sorted(trace, key=lambda e: e[0])]
    return sched, engines["cnet_plus_scalar"], counts, inputs


@phase("served outputs vs the port's CPU engine (plain versions), "
       "bit-exact")
def reference_phase(torch, sched, card_engine, inputs):
    import numpy as np
    from repro_torch.core.engine import Engine
    cpu = Engine(card_engine.graph,
                 {n: {k: v.cpu() for k, v in p.items()}
                  for n, p in card_engine.params.items()}, device="cpu")
    cpu.share_calibration(card_engine)
    comps = sorted(sched.completions, key=lambda c: c.rid)
    t0 = time.perf_counter()
    worst = 0.0
    for i in range(0, len(comps), BATCH):
        chunk = comps[i:i + BATCH]
        reqs = [inputs[c.rid] for c in chunk]
        batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
        want = cpu.run_batch(batch, "accel")["head"]
        got = torch.from_numpy(np.stack([c.outputs["head"] for c in chunk]))
        worst = max(worst, exact(torch, got, want))
        assert np.isfinite(got.numpy()).all()
    print(f"   {len(comps)} outputs bit-exact (max |diff| {worst}); CPU "
          f"reference took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    records = []
    if build_phase() is not None:
        gen = torch.Generator().manual_seed(0)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for ph in (matmul_phase, conv_phase, quantize_phase):
            rec = ph(torch, gen, flush)
            if rec is not None:
                records.append(rec)
        del flush
        served = serve_phase(torch)
        if served is not None:
            sched, engine, counts, inputs = served
            reference_phase(torch, sched, engine, inputs)
            profile_phase(torch, engine, inputs)
            for rec in records:
                rec["launches"] = counts[rec["name"]]
                if rec["launches"] == 0:
                    FAILURES.append(f"{rec['name']} never launched")
    if len(records) != 3:
        FAILURES.append("kernel records missing")
    print(json.dumps({"kernels": records}), flush=True)
    print(gpu_line(), flush=True)
    if FAILURES:
        print(f"FAILED phases: {FAILURES}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
