"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc
(one process per source, all at once), holds each kernel against its
plain PyTorch version at the shapes the served models give it and times
both, then drives the port's two served paths through their launcher
functions:

* cnet_plus_scalar at full published width on the int8 ``accel`` backend
  through the continuous-batching scheduler, held bit-exact against the
  port's CPU engine (the plain versions) sharing weights and calibration;
* the telemetry LM's decoder block at zamba2-1.2b widths on ``accel``
  through the LM scheduler (8 requests of 16 tokens over 4 KV slots),
  with the per-dispatch launch counts checked, then one request's prefill
  and 4 decode steps held against the port's CPU engine;
* cnet_plus_scalar again with ``--autotune --tuning-cache``: the same
  trace served through the plan-time autotuner (prepacked weights, the
  stem's channel-blocked conv grid), bit-identical to the untuned served
  outputs, then a second engine over the saved cache that must search
  nothing;
* the LM block autotuned at zamba2 widths: one request's prefill and 4
  decode steps held against the untuned engine's on the card;
* the paper's other five networks at their published widths on
  ``accel`` (vae_encoder, multi_esperta, logistic_net, reduced_net,
  baseline_net), each through the scheduler with the launch counts its
  plan gives (``qplans``), and held against the port's CPU engine: int8
  chains bit-exact, fp32 conv3d feeding an int8 dense within the
  reference's accel bound, ESPERTA's prob to 1e-6, the VAE's sample to
  2e-6; one B=16 dispatch of baseline_net and of vae_encoder profiled.

Besides the kernels those paths run, the fp32 ``conv2d`` (on no served
path, as in the reference) is held against its plain version and timed
beside cuDNN's convolution. ``sample_normal`` (the VAE's sampler) replaces
XLA's RNG, not a Pallas kernel: its record names the reference's
``jax.random.normal`` call, and the check that every ``pallas_call`` has
a record counts the Pallas records only.

``int8_matmul`` has two CUDA kernels, chosen by shape
(``kernels/int8_matmul.py: route``): each shape is timed on the kernel
its route picks, each kernel has its own record in the kernels line
(``int8_matmul:tile``, ``int8_matmul:splitk``), small-M shapes are timed
on both kernels by the profiler's device clock beside the rule's choice,
and the served paths assert the per-kernel counts (a prefill's
projections all take the tensor-core tile kernel, CNet's dense layers the
split-K kernel). The split-K shapes also print their device time by the
profiler's clock (weights from HBM), and a second call with no memset
between equals the first. ``flash_attention`` and ``ssd`` are bounded by
the arithmetic of their 3xTF32 designs at the dense TF32 rate. An LM
prefill caches the ``ssd`` kernel's final state: its profile must hold
no per-position state scan, and its cached state matches the CPU
engine's within 1e-4.

The launch counters show that each path ran its kernels (counts are set
to 0 just before a path is driven and read just after); a profiler pass
breaks each path's device time down by kernel. Any failed phase makes the
exit code non-zero; the last line is a JSON verdict only on success.

    python3 chip_smoke.py --conv-only [SRC]
    python3 chip_smoke.py --ssd-splitk-only [SRC]
    python3 chip_smoke.py --quantize-only [SRC]

build the kernels of another checkout's ``src/`` (this one's by
default) and run only the three conv phases, only the ssd phase and
int8_matmul's split-K shapes, or only the quantize phase, so that two
commits' kernels are timed on one card in one call (run parent, change,
change, parent).

Needs a CUDA card and the repository's ``src/`` beside this file. Imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# H100 SXM data-sheet peaks: HBM3 rate, dense int8 and fp32 (non-tensor) rates
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_FP32_OPS_S = 67e12
PEAK_TF32_OPS_S = 495e12

BATCH = 16
LADDER_TOP = 16
N_REQUESTS = 48

# the LM slice: zamba2-1.2b widths, 8 requests x 16 tokens over 4 slots
LM_REQUESTS = 8
LM_TOKENS = 16
LM_SLOTS = 4
LM_REF_STEPS = 4
# card vs CPU engine on the LM's accel path (see lm_reference_phase)
LM_LOGITS_ATOL = 2e-2
# the kernels each served path must launch
CNN_KERNELS = ("int8_matmul", "conv2d_int8", "quantize_apply")
LM_KERNELS = ("int8_matmul", "quantize_apply", "flash_attention", "ssd")
TUNED_CNN_KERNELS = ("int8_matmul", "conv2d_int8", "conv2d_int8_cout_blocks",
                     "quantize_apply")
TUNED_LM_KERNELS = ("int8_matmul", "flash_attention", "ssd")
# the paper's other five networks, served on accel at published widths
SPACE_MODELS = ("vae_encoder", "multi_esperta", "logistic_net",
                "reduced_net", "baseline_net")
# card vs CPU engine where fp32 conv3d (cuDNN vs oneDNN) feeds the int8
# fc1: the reference's own accel bounds (tests/test_conformance.py)
ACCEL_ATOL = {"reduced_net": 0.02, "baseline_net": 0.05}
# float32 ops a sampled element takes in csrc/sample_normal.cu: threefry
# (20 rounds of 5, 5 key injections of 3, 2 + 1), the float and Giles'
# erfinv (~40 with log1pf), exp and the multiply-add (~13)
SAMPLE_OPS = 171
# the weight matrices calibration quantizes ([K, N], one quantize_apply
# launch each): CNet's five, the LM block's eleven at zamba2-1.2b widths
# (models/lm.py: build_graph, ZAMBA2_1_2B), then the other five networks'
# (the VAE's seven; ESPERTA's six [3, 1] alike, one timed; the MMS nets')
QUANTIZE_WEIGHTS = (
    ("cnet", "conv0", 18, 48), ("cnet", "conv1", 432, 48),
    ("cnet", "conv2", 432, 32), ("cnet", "fc1", 32769, 92),
    ("cnet", "head", 92, 1),
    ("lm", "emb", 2048, 2048), ("lm", "q_proj", 2048, 2048),
    ("lm", "k_proj", 2048, 2048), ("lm", "v_proj", 2048, 2048),
    ("lm", "out_proj", 2048, 2048), ("lm", "ssm_in", 2048, 4096),
    ("lm", "b_proj", 2048, 64), ("lm", "c_proj", 2048, 64),
    ("lm", "dt_proj", 2048, 64), ("lm", "down_proj", 4096, 2048),
    ("lm", "head", 2048, 32000),
    ("vae", "conv0", 27, 8), ("vae", "conv1", 72, 32),
    ("vae", "conv2", 288, 96), ("vae", "conv3", 864, 144),
    ("vae", "conv4", 1296, 144), ("vae", "mu", 4608, 6),
    ("vae", "logvar", 4608, 6),
    ("esperta", "logit0", 3, 1),
    ("mms", "logistic head", 2048, 4), ("mms", "reduced fc1", 1024, 43),
    ("mms", "reduced head", 43, 4), ("mms", "baseline fc1", 12288, 73),
    ("mms", "baseline head", 73, 4))
# every pallas_call of the reference has a record in the kernels line
# (int8_matmul one for each of its two CUDA kernels)
TPU_KERNELS = {
    "int8_matmul": "src/repro/kernels/int8_matmul.py:136",
    "quantize_apply": "src/repro/kernels/quantize.py:49",
    "conv2d_int8": "src/repro/kernels/conv2d.py:284",
    "conv2d_int8_cout_blocks": "src/repro/kernels/conv2d.py:303",
    "flash_attention": "src/repro/kernels/flash_attention.py:115",
    "ssd": "src/repro/kernels/ssd.py:100",
    "conv2d": "src/repro/kernels/conv2d.py:141",
}
# the port's kernels with no pallas_call behind them: what each replaces
OTHER_KERNELS = {
    "sample_normal": "src/repro/core/plan.py:140",     # jax.random.normal
}

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


def close(torch, got, want, tol: float) -> float:
    """Max |got - want|; raises unless within ``tol`` (absolute and
    relative) and finite."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    err = float((got.double() - want.double()).abs().max())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return err


def device_rows(torch, prof):
    """(device us, count, name) of the profile's device-side events
    (kernels, copies), largest first. The CPU-side operator rows carry the
    device time of the kernels they launched too; summing both would
    count that time twice."""
    cpu = torch.autograd.DeviceType.CPU
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type != cpu and dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def counts_with_routes(ops):
    """The launch counters, plus int8_matmul's launches by kernel under
    ``int8_matmul:tile`` and ``int8_matmul:splitk``."""
    counts = ops.launch_counts()
    counts.update({f"int8_matmul:{k}": v
                   for k, v in ops.route_counts().items()})
    return counts


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
def build_phase(names=None):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all(names)
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


@phase("int8_matmul vs plain, each shape on the kernel its route picks "
       "(CNet fc1 and head at B=16; the LM's prefill projections at B=4 x "
       "2048 positions, decode head and down_proj at 4 lanes; ESPERTA's "
       "six K = 3, N = 1 sigmoid layers (one shape); the MMS nets' and the "
       "VAE's dense layers at B=16; prepacked: fc1 and head in their tuned "
       "layouts, the LM head at one prompt)")
def matmul_phase(torch, gen, flush, only=None):
    """Each shape on the kernel its route picks (``only``: the shapes of
    one route). Split-K shapes also print their device time by the
    profiler's clock, each call on its own weight copy (from HBM), and a
    second call's output, with no memset between, equals the first."""
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels.epilogue import pad_channel_params
    dev = "cuda"
    cases = []
    # (M, K, N, act, requant, packed layout (bk, bn) or None): fc1 =
    # dense+relu+requant, head = dense; the LM's per-position projections
    # fold batch x positions into M. The layouts are the autotuner's picks
    # for these nodes (printed by the served autotuned paths below).
    for m, k, n, act, rq, layout in (
            (BATCH, 32769, 92, "relu", 0.0123456789, None),
            (BATCH, 92, 1, None, None, None),
            (4 * 2048, 2048, 2048, None, 0.0153, None),
            (4 * 2048, 2048, 4096, None, None, None),
            (4 * 2048, 2048, 64, "sigmoid", None, None),
            (4 * 2048, 4096, 2048, None, None, None),
            (4 * 2048, 2048, 32000, None, None, None),
            (LM_SLOTS, 2048, 32000, None, None, None),
            (LM_SLOTS, 4096, 2048, None, None, None),
            (BATCH, 3, 1, "sigmoid", None, None),
            # logistic_net head; reduced_net fc1 (+relu, requant) and head;
            # baseline_net fc1 and head; the VAE's mu/logvar (each alike)
            (BATCH, 2048, 4, None, None, None),
            (BATCH, 1024, 43, "relu", 0.0173, None),
            (BATCH, 43, 4, None, None, None),
            (BATCH, 12288, 73, "relu", 0.0191, None),
            (BATCH, 73, 4, None, None, None),
            (BATCH, 4608, 6, None, None, None),
            (BATCH, 32769, 92, "relu", 0.0123456789, (1024, 96)),
            (BATCH, 92, 1, None, None, (96, 8)),
            (2048, 2048, 32000, None, None, (1024, 256))):
        which = mm.route(m, k, n)
        if only is not None and which != only:
            continue
        big = m * n > 1 << 24
        x = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        xs = (torch.rand(m, generator=gen) * 0.01 + 1e-3).to(dev)
        ws = (torch.rand(n, generator=gen) * 0.01 + 1e-3).to(dev)
        b = torch.randn(n, generator=gen).to(dev)
        if layout is None:
            wk, wsk, bk_ = w, ws, b
            tiles = {}
        else:
            bk, bn = layout
            kp, np_ = -(-k // bk) * bk, -(-n // bn) * bn
            wk = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
            wsk, bk_ = pad_channel_params(ws, b, np_ - n)
            tiles = dict(bm=BATCH, bn=bn, bk=bk, prepacked=True, n_out=n)
        before = dict(ops.route_counts())
        out = mm.int8_matmul(x, wk, xs, wsk, bk_, act=act, requant_scale=rq,
                             **tiles)
        torch.cuda.synchronize()
        assert ops.route_counts()[which] == before[which] + 1, which
        ref = mm.int8_matmul_plain(x, w, xs, ws, b, act, rq)
        if act == "sigmoid":    # library expf may differ by an ulp
            err = close(torch, out, ref, 1e-6)
        else:
            err = exact(torch, out, ref)
        dev_us = None
        if which == "splitk":
            again = mm.int8_matmul(x, wk, xs, wsk, bk_, act=act,
                                   requant_scale=rq, **tiles)
            exact(torch, again, out)
            dev_us = weight_cold_us(torch, lambda wi: mm.int8_matmul(
                x, wi, xs, wsk, bk_, act=act, requant_scale=rq, **tiles), wk)
        t = device_ms(torch, lambda: mm.int8_matmul(
            x, wk, xs, wsk, bk_, act=act, requant_scale=rq, **tiles),
            10 if big else 50, flush)
        tp = device_ms(torch, lambda: mm.int8_matmul_plain(
            x, w, xs, ws, b, act, rq), 3 if big else 10, flush)
        # torch._int_mm (int8 x int8 -> int32, matmul only, no epilogue)
        # needs M > 16 and K, N multiples of 8: time it on the shape
        # rounded up to what it accepts
        mp, kp8, np8 = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        xl = torch.zeros((mp, kp8), dtype=torch.int8, device=dev)
        wl = torch.zeros((kp8, np8), dtype=torch.int8, device=dev)
        xl[:m, :k], wl[:k, :n] = x, w
        tl = library_ms(torch, xl, wl, flush)
        del xl, wl
        out_bytes = m * n * (1 if rq is not None else 4)
        # bytes the function must move: the logical operands (x, the
        # [k, n] weights, the scales and bias) and the output; the zeros of
        # a packed layout are read by neither the function nor the kernel
        nbytes = m * k + k * n + 4 * (m + 2 * n) + out_bytes
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, PEAK_INT8_OPS_S)
        packed = ("" if layout is None else
                  f" prepacked [{wk.shape[0]},{wk.shape[1]}] (bk={layout[0]}"
                  f", bn={layout[1]})")
        cases.append(dict(shape=f"[{m},{k}]x[{k},{n}] act={act} requant="
                          f"{rq is not None}{packed} route={which}",
                          route=which, err=err, ms=t,
                          plain_ms=tp, library_ms=tl, bound_ms=bms,
                          bound_by=by))
        _print_case(cases[-1])
        if dev_us is not None:
            print(f"     device_us={_fmt(dev_us)} (profiler, weights from "
                  f"HBM); a second call, no memset between: bit-exact")
    print("   library_ms: torch._int_mm on [17+,K8]x[K8,N8], the matmul only; "
          "sigmoid held at rtol 1e-6, the rest bit-exact")
    if only in (None, "splitk"):
        memsets = splitk_memsets(torch, mm)
        # this tree's split-K launches no memset (a compared checkout may)
        assert only is not None or not memsets, memsets
    # one TPU kernel, two CUDA kernels chosen by shape (kernels/
    # int8_matmul.py: route): one record each, named as the route counters
    return [_kernel_record(f"int8_matmul:{r}", f"src/repro_torch/csrc/{src}",
                           TPU_KERNELS["int8_matmul"],
                           [c for c in cases if c["route"] == r])
            for r, src in (("tile", "int8_matmul_tile.cu"),
                           ("splitk", "int8_matmul.cu"))
            if only in (None, r)]


def splitk_memsets(torch, mm):
    """The device events of two split-K fc1 calls in a row: the kernel
    alone, no memset (printed for a tree whose wrapper zeroes a scratch
    per call too)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones((BATCH, 32769), dtype=torch.int8, device="cuda")
    w = torch.ones((32769, 92), dtype=torch.int8, device="cuda")
    xs, ws = torch.ones(BATCH, device="cuda"), torch.ones(92, device="cuda")
    mm.int8_matmul(x, w, xs, ws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            mm.int8_matmul(x, w, xs, ws)
        torch.cuda.synchronize()
    rows = device_rows(torch, prof)
    print(f"   device events of two split-K fc1 calls: "
          f"{[(key[:40], count) for _, count, key in rows]}")
    return [key for _, _, key in rows if "memset" in key.lower()]


@contextlib.contextmanager
def forced_route(mm, which):
    """Serve int8_matmul on ``which`` whatever the shape rule says."""
    rule = mm.route
    mm.route = lambda m, k, n: which
    try:
        yield
    finally:
        mm.route = rule


def profile_rows(torch, calls):
    """The device events of ``calls``, each called once after a warm-up
    call of the first (``device_rows``)."""
    from torch.profiler import ProfilerActivity, profile
    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in calls:
            c()
        torch.cuda.synchronize()
    return device_rows(torch, prof)


def per_call_device_us(torch, calls, show=False):
    """Device time per call in us (torch.profiler: every device event the
    calls launch, a scratch fill included), each call once; the host's
    launch work between calls is not counted. None when the profiler
    recorded no device time (the tracer, not the port). ``show`` prints
    each event's share."""
    rows = profile_rows(torch, calls)
    if show:
        for dev_us, count, key in rows:
            print(f"     {dev_us / len(calls):10.2f} us/call  "
                  f"x{count // len(calls)} {key[:60]}")
    return sum(r[0] for r in rows) / len(calls) if rows else None


def weight_cold_us(torch, call, w):
    """Device us per ``call(w_i)`` by the profiler, each call on its own
    copy of the weights ``w``, as many copies as fill 128 MB (16 at least,
    1024 at most), so that they come from HBM as in a served step, where
    the other layers' weights evict them."""
    k, n = w.shape
    copies = max(16, min(1024, -(-(128 << 20) // (k * n))))
    w_copies = w.expand(copies, k, n).contiguous()
    try:
        return per_call_device_us(torch, [(lambda wi=wi: call(wi))
                                          for wi in w_copies])
    finally:
        del w_copies


def conv_device_ms(torch, fn, n: int = 20):
    """A conv call's device time in ms by the profiler's clock (the mean
    over ``n`` back-to-back calls; their inputs stay in L2, as a served
    layer finds the activation its producer just wrote), or None when the
    profiler recorded no device time. Event-timed ``ms`` of a call of tens
    of us carries the wrapper's host work; this does not."""
    us = per_call_device_us(torch, [fn] * n)
    return None if us is None else us / 1e3


def _fmt(v):
    return "not measured" if v is None else f"{v:.4f}"


def _smem(cv, cin, bc, requant, stride=1):
    """The int8 conv block's shared memory (an older checkout's size
    query takes no output type)."""
    try:
        return cv.smem_bytes(cin, bc, 3, 3, stride, requant)
    except TypeError:
        return cv.smem_bytes(cin, bc, 3, 3, stride)


@phase("int8_matmul route rule: device time of both kernels at small M "
       "(the LM's projections at M = 1, 4, 16, 32, 64; CNet's fc1 and "
       "head at B=16)")
def route_phase(torch, gen, flush):
    """Both CUDA kernels on the same operands, timed by the profiler's
    device clock (the event-timed ``ms`` of a ~0.05 ms call is mostly host
    work). Each call reads its own copy of the weights, as many copies as
    fill 128 MB (16 at least, 1024 at most), so the weights come from HBM
    as in a served step, where the other layers' weights evict them."""
    from repro_torch.kernels import int8_matmul as mm
    dev = "cuda"
    widths = ((2048, 2048), (2048, 4096), (4096, 2048), (2048, 64),
              (2048, 32000))
    shapes = ([(m, k, n) for m in (1, LM_SLOTS, 16, 32, 64)
               for k, n in widths]
              + [(BATCH, 32769, 92), (BATCH, 92, 1)])
    agree = measured = 0
    for m, k, n in shapes:
        copies = max(16, min(1024, -(-(128 << 20) // (k * n))))
        x = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        xs, ws = torch.ones(m, device=dev), torch.ones(n, device=dev)
        us = {}
        for r in ("tile", "splitk"):
            flush.zero_()
            with forced_route(mm, r):
                us[r] = weight_cold_us(
                    torch, lambda wi: mm.int8_matmul(x, wi, xs, ws), w)
        rule = mm.route(m, k, n)
        if None in us.values():
            print(f"   [{m},{k}]x[{k},{n}]: the profiler recorded no device "
                  f"time: not measured; rule {rule}")
            continue
        faster = min(us, key=us.get)
        agree += rule == faster
        measured += 1
        print(f"   [{m},{k}]x[{k},{n}]: tile {us['tile']:.2f} us, splitk "
              f"{us['splitk']:.2f} us per call (device, {copies} weight "
              f"copies); rule {rule}, faster {faster}")
    print(f"   the rule picks the faster kernel at {agree} of the {measured} "
          f"shapes measured ({len(shapes)} tried)")


@phase("conv2d_int8 vs plain (CNet's conv0/1/2 and the VAE's five "
       "stride-2 convs, at B=16)")
def conv_phase(torch, gen, flush):
    from repro_torch.kernels import conv2d as cv
    dev = "cuda"
    cases = []
    # (H, W, Cin, Cout, stride, requant): CNet's three, then the VAE's
    # five (int8 in, relu, requantized for the next; the last feeds mu and
    # logvar through flatten)
    for h, w_, cin, cout, stride, rq in (
            (256, 256, 2, 48, 1, 0.02), (128, 128, 48, 48, 1, 0.0163),
            (64, 64, 48, 32, 1, None),
            (128, 256, 3, 8, 2, 0.0241), (64, 128, 8, 32, 2, 0.0286),
            (32, 64, 32, 96, 2, 0.0228), (16, 32, 96, 144, 2, 0.0172),
            (8, 16, 144, 144, 2, 0.011)):
        x = torch.randint(-127, 128, (BATCH, h, w_, cin), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                          dtype=torch.int8).to(dev)
        ws = (torch.rand(cout, generator=gen) * 0.01).to(dev)
        b = torch.randn(cout, generator=gen).to(dev)
        kw = dict(x_scale=0.00876, stride=stride, padding="SAME",
                  act="relu", requant_scale=rq)
        before = (cv.launches, cv.launches_cout_blocks)
        out = cv.conv2d_int8(x, w, ws, b, **kw)
        torch.cuda.synchronize()
        # a whole-Cout call counts as such, whichever grid it took
        assert (cv.launches, cv.launches_cout_blocks) == (
            before[0] + 1, before[1])
        ref = cv.conv2d_int8_plain(x, w, ws, b, **kw)
        err = exact(torch, out, ref)
        t = device_ms(torch, lambda: cv.conv2d_int8(x, w, ws, b, **kw), 30,
                      flush)
        td = conv_device_ms(torch, lambda: cv.conv2d_int8(x, w, ws, b, **kw))
        tp = device_ms(torch, lambda: cv.conv2d_int8_plain(x, w, ws, b, **kw),
                       5, flush)
        n_out = out.numel()
        out_bytes = n_out * (1 if rq is not None else 4)
        nbytes = x.numel() + w.numel() + 8 * cout + out_bytes
        ops = 2.0 * n_out * 9 * cin
        bms, by = bound_ms(nbytes, ops, PEAK_INT8_OPS_S)
        cases.append(dict(shape=f"[{BATCH},{h},{w_},{cin}]->{cout} stride "
                          f"{stride} requant={rq is not None}", err=err,
                          ms=t, plain_ms=tp, library_ms=None, bound_ms=bms,
                          bound_by=by, device_ms=td))
        _print_case(cases[-1])
        def smem(c):
            return _smem(cv, cin, c, rq is not None, stride)
        whole, grid = smem(cout), "whole Cout"
        if whole > 232448:
            bc = cv.fit_channel_block(cout, smem)
            grid = (f"channel blocks of {bc} ({smem(bc)} B each; whole Cout "
                    f"would need {whole} B)")
        print(f"     device_ms={_fmt(td)} (profiler); grid: {grid}; dynamic "
              f"shared memory per whole-Cout block: {whole} B")
    print("   library_ms: none (PyTorch has no int8 convolution on CUDA)")
    return _kernel_record("conv2d_int8", "src/repro_torch/csrc/conv2d_int8.cu",
                          TPU_KERNELS["conv2d_int8"], cases)


@phase("conv2d_int8_cout_blocks vs plain (CNet act0 as tuned: B=16, "
       "256x256x2 -> 48, rows 256, pre-padded, bc 16; a 3x3x128 -> 512 "
       "filter on 32x32 that one block cannot hold whole, bc 64)")
def conv_blocks_phase(torch, gen, flush):
    from repro_torch.kernels import conv2d as cv
    dev = "cuda"
    cases = []
    # (B, H, W, Cin, Cout, bc, rows, requant, pre-padded)
    for b, h, w_, cin, cout, bc, rows, rq, pre in (
            (BATCH, 256, 256, 2, 48, 16, 256, 0.02, True),
            (BATCH, 32, 32, 128, 512, 64, 8, 0.02, False)):
        x = torch.randint(-127, 128, (b, h, w_, cin), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen,
                          dtype=torch.int8).to(dev)
        ws = (torch.rand(cout, generator=gen) * 0.01).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        kw = dict(x_scale=0.00876, stride=1, padding="SAME", act="relu",
                  requant_scale=rq, rows_per_block=rows)
        whole = _smem(cv, cin, cout, rq is not None)
        if whole > 232448:
            # a whole-Cout call the block cannot hold takes the channel-
            # blocked grid with the largest block that fits, counted whole
            before = (cv.launches, cv.launches_cout_blocks)
            fitted = cv.conv2d_int8(x, w, ws, bias, **kw)
            torch.cuda.synchronize()
            assert (cv.launches, cv.launches_cout_blocks) == (
                before[0] + 1, before[1])
            exact(torch, fitted, cv.conv2d_int8_plain(x, w, ws, bias, **kw))
            bc_fit = cv.fit_channel_block(
                cout, lambda c: _smem(cv, cin, c, rq is not None))
            print(f"   whole-Cout ({whole} B) ran the channel-blocked grid "
                  f"with blocks of {bc_fit}: bit-exact")
        if pre:
            g = cv.conv_geometry(h, w_, 3, 3, 1, "SAME", rows)
            xk = cv.pad_input(x, g)
            kw_k = dict(kw, pre_padded=True, in_hw=(h, w_))
        else:
            xk, kw_k = x, kw
        before = cv.launches_cout_blocks
        out = cv.conv2d_int8(xk, w, ws, bias, cout_per_block=bc, **kw_k)
        torch.cuda.synchronize()
        assert cv.launches_cout_blocks == before + 1
        ref = cv.conv2d_int8_plain(xk, w, ws, bias, **kw_k)
        err = exact(torch, out, ref)
        t = device_ms(torch, lambda: cv.conv2d_int8(
            xk, w, ws, bias, cout_per_block=bc, **kw_k), 30, flush)
        td = conv_device_ms(torch, lambda: cv.conv2d_int8(
            xk, w, ws, bias, cout_per_block=bc, **kw_k))
        tp = device_ms(torch, lambda: cv.conv2d_int8_plain(
            xk, w, ws, bias, **kw_k), 5, flush)
        out_bytes = b * h * w_ * cout * (1 if rq is not None else 4)
        # the logical input, not the pre-padded copy the kernel reads
        nbytes = x.numel() + w.numel() + 8 * cout + out_bytes
        ops = 2.0 * b * h * w_ * cout * 9 * cin
        bms, by = bound_ms(nbytes, ops, PEAK_INT8_OPS_S)
        cases.append(dict(shape=f"[{b},{h},{w_},{cin}]->{cout} bc={bc} "
                          f"rows={rows} pre_padded={pre}", err=err, ms=t,
                          plain_ms=tp, library_ms=None, bound_ms=bms,
                          bound_by=by))
        _print_case(cases[-1])
        print(f"     device_ms={_fmt(td)} (profiler); dynamic shared "
              f"memory per block: "
              f"{_smem(cv, cin, bc, rq is not None)} B with "
              f"channel blocks, "
              f"{whole} B whole-Cout; {-(-cout // bc)} channel blocks")
    print("   library_ms: none (PyTorch has no int8 convolution on CUDA)")
    return _kernel_record("conv2d_int8_cout_blocks",
                          "src/repro_torch/csrc/conv2d_int8.cu",
                          TPU_KERNELS["conv2d_int8_cout_blocks"], cases)


@phase("conv2d (fp32) vs plain (the VAE stem: B=16, 128x256x3 -> 8, "
       "stride 2; CNet's stem in fp32: B=16, 256x256x2 -> 48)")
def conv_f32_phase(torch, gen, flush):
    import torch.nn.functional as F
    from repro_torch.kernels import conv2d as cv
    dev = "cuda"
    cases = []
    # (B, H, W, Cin, Cout, stride)
    for b, h, w_, cin, cout, stride in ((BATCH, 128, 256, 3, 8, 2),
                                        (BATCH, 256, 256, 2, 48, 1)):
        x = torch.randn((b, h, w_, cin), generator=gen).to(dev)
        w = (torch.randn((3, 3, cin, cout), generator=gen) * 0.1).to(dev)
        bias = (torch.randn(cout, generator=gen) * 0.1).to(dev)
        kw = dict(stride=stride, padding="SAME", relu=True)
        before = cv.launches_f32
        out = cv.conv2d(x, w, bias, **kw)
        torch.cuda.synchronize()
        assert cv.launches_f32 == before + 1
        err = close(torch, out, cv.conv2d_plain(x, w, bias, **kw), 1e-4)
        t = device_ms(torch, lambda: cv.conv2d(x, w, bias, **kw), 30, flush)
        tp = device_ms(torch, lambda: cv.conv2d_plain(x, w, bias, **kw), 5,
                       flush)
        # the yardstick: cuDNN through F.conv2d, channels-last, TF32 off,
        # on the input padded beforehand (SAME is asymmetric here)
        g = cv.conv_geometry(h, w_, 3, 3, stride, "SAME")
        xl = cv.pad_input(x, g).permute(0, 3, 1, 2)       # NHWC memory
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = F.relu(F.conv2d(xl, wl, bias, stride=stride)).permute(
            0, 2, 3, 1)
        close(torch, lib, out, 1e-4)
        tl = device_ms(torch, lambda: F.conv2d(xl, wl, bias, stride=stride),
                       30, flush)
        td = conv_device_ms(torch, lambda: cv.conv2d(x, w, bias, **kw))
        tld = conv_device_ms(torch, lambda: F.conv2d(xl, wl, bias,
                                                     stride=stride))
        nbytes = 4 * (x.numel() + w.numel() + cout + out.numel())
        ops = 2.0 * out.numel() * 9 * cin
        bms, by = bound_ms(nbytes, ops, PEAK_FP32_OPS_S)
        cases.append(dict(shape=f"[{b},{h},{w_},{cin}]->{cout} stride "
                          f"{stride}", err=err, ms=t, plain_ms=tp,
                          library_ms=tl, bound_ms=bms, bound_by=by))
        _print_case(cases[-1])
        print(f"     device_ms={_fmt(td)}, cuDNN device_ms={_fmt(tld)} "
              f"(profiler); "
              f"{cv.f32_block_channels(cin, cout, 3, 3, stride)} "
              f"output channels per block")
    print("   tolerance 1e-4 (abs and rel) against the plain version; "
          "library_ms: F.conv2d with bias (cuDNN, TF32 off, no relu) on the "
          "pre-padded channels-last input")
    return _kernel_record("conv2d", "src/repro_torch/csrc/conv2d_f32.cu",
                          TPU_KERNELS["conv2d"], cases)


@phase("sample_normal vs plain (the VAE's sampling tail: B=16 samples of "
       "6, the record's shape; and 16 of 100,000)")
def sample_phase(torch, gen, flush):
    """The kernel's threefry bits equal the plain version's exactly; eps
    and the sample hold to the plain version (on the card) within 2e-6
    relative, atol 1e-6 (the card's log1pf and expf against PyTorch's)."""
    from repro_torch.kernels import sample as smp
    dev = "cuda"
    cases = []
    # the served shape makes the record; the long one is printed only
    for b, n, served in ((BATCH, 6, True), (BATCH, 100_000, False)):
        keys = torch.randint(0, 2 ** 32, (b, 2), generator=gen,
                             dtype=torch.int64)
        mu = torch.randn((b, n), generator=gen).to(dev)
        lv = torch.randn((b, n), generator=gen).to(dev)
        before = smp.launches
        bits = smp.random_bits_kernel(keys, n, mu.device)
        out = smp.sample_normal(mu, lv, keys)
        torch.cuda.synchronize()
        assert smp.launches == before + 2
        exact(torch, bits, smp.random_bits(keys.to(dev), n))
        zeros = torch.zeros_like(mu)
        close(torch, smp.sample_normal(zeros, zeros, keys),
              smp.normal_plain(keys.to(dev), n), 2e-6)
        ref = smp.sample_normal_plain(mu, lv, keys)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite samples")
        torch.testing.assert_close(out, ref, rtol=2e-6, atol=1e-6)
        err = float((out.double() - ref.double()).abs().max())
        # timed as served: the keys on the host, copied in by the wrapper
        t = device_ms(torch, lambda: smp.sample_normal(mu, lv, keys), 50,
                      flush)
        print(f"   [{b},{n}] device events per call (keys from the host):")
        td = per_call_device_us(
            torch, [lambda: smp.sample_normal(mu, lv, keys)] * 20, show=True)
        td = None if td is None else td / 1e3
        keys_dev = keys.to(dev)
        tp = device_ms(torch, lambda: smp.sample_normal_plain(mu, lv,
                                                              keys_dev),
                       10, flush)
        # mu, logvar and the keys read once, the sample written once
        nbytes = 4 * (3 * b * n) + 8 * b
        bms, by = bound_ms(nbytes, SAMPLE_OPS * b * n, PEAK_FP32_OPS_S)
        case = dict(shape=f"[{b},{n}]", err=err, ms=t, plain_ms=tp,
                    library_ms=None, bound_ms=bms, bound_by=by)
        if served:
            cases.append(case)
        _print_case(case)
        print(f"     device_ms={_fmt(td)} (profiler); bits exact")
    print("   tolerance 2e-6 relative (atol 1e-6) against the plain version; "
          "library_ms: none (PyTorch has no threefry; torch.randn draws "
          "other numbers)")
    return _kernel_record("sample_normal",
                          "src/repro_torch/csrc/sample_normal.cu",
                          OTHER_KERNELS["sample_normal"], cases)


def _cold_inputs(x, n: int = 8):
    """``n`` or more inputs for back-to-back calls, cycling over copies of
    ``x`` that fill 128 MB (at most 256), so that at the LM's shapes each
    call reads its matrix from HBM, as calibration does (the head's 262 MB
    alone exceeds the 50 MB L2)."""
    k = min(256, max(1, -(-(128 << 20) // (4 * x.numel()))))
    xs = [x] + [x.clone() for _ in range(k - 1)]
    return [xs[i % k] for i in range(max(n, k))]


def _calls(fn, inputs):
    return [(lambda xi=xi: fn(xi)) for xi in inputs]


def _us_sum(cases, key):
    vals = [c[key] for c in cases]
    return None if any(v is None for v in vals) else sum(vals)


@phase("quantize_apply vs plain (the weights calibration quantizes: CNet's "
       "five, the LM's eleven at zamba2-1.2b widths, the VAE's seven, "
       "ESPERTA's [3, 1], the MMS nets' five)")
def quantize_phase(torch, gen, flush):
    """Each weight shape: bit-exact to the plain version, the kernel's
    device time by the profiler (HBM-cold matrices) beside its event time,
    its byte bound, torch.quantize_per_channel's device time (a yardstick
    of time: it may divide where the kernel multiplies by the reciprocal,
    so a code can move by one) and the device time of the scale reduction
    in front of the kernel (``quantize`` minus the kernel's events)."""
    from repro_torch.kernels import quantize as qz
    dev = "cuda"
    lm_gen = torch.Generator(device=dev).manual_seed(17)
    cases = []
    for model, name, m, n in QUANTIZE_WEIGHTS:
        if model == "cnet":
            x = torch.randn((m, n), generator=gen).to(dev)
        else:
            x = torch.randn((m, n), generator=lm_gen, device=dev)
        scale = x.abs().amax(0) / 127.0 + 1e-12
        before = qz.launches
        out = qz.quantize_apply(x, scale)
        torch.cuda.synchronize()
        assert qz.launches == before + 1
        err = exact(torch, out, qz.quantize_apply_plain(x, scale))
        q2, s2 = qz.quantize(x)
        exact(torch, s2, scale)
        exact(torch, q2, out)
        del q2, s2
        t = device_ms(torch, lambda: qz.quantize_apply(x, scale), 20, flush)
        tp = device_ms(torch, lambda: qz.quantize_apply_plain(x, scale), 5,
                       flush)
        xs = _cold_inputs(x)
        kern_us = per_call_device_us(torch, _calls(
            lambda xi: qz.quantize_apply(xi, scale), xs))
        rows = profile_rows(torch, _calls(qz.quantize, xs))
        scale_us = (sum(us for us, _, key in rows
                        if "quantize_apply" not in key) / len(xs)
                    if rows else None)
        # the yardstick: one PyTorch call computing the same codes
        zeros = torch.zeros(n, dtype=torch.long, device=dev)
        sd = scale.double()
        lib_us, lib_note = None, ""
        try:
            lq = torch.quantize_per_channel(x, sd, zeros, 1, torch.qint8)
            torch.cuda.synchronize()
            moved = int((lq.int_repr() != out).sum())
            lib_note = f"{moved} codes differ from the kernel's"
            del lq
            lib_us = per_call_device_us(torch, _calls(
                lambda xi: torch.quantize_per_channel(
                    xi, sd, zeros, 1, torch.qint8), xs))
        except RuntimeError as e:
            lib_note = f"refused: {str(e).splitlines()[0]}"
        # for information, the card's streaming rate at this size: a
        # device-to-device copy of x (8 bytes an element)
        y = torch.empty_like(x)
        copy_us = per_call_device_us(torch, _calls(y.copy_, xs))
        del y
        nbytes = 4 * m * n + 4 * n + m * n
        bms, by = bound_ms(nbytes, 3.0 * m * n, PEAK_FP32_OPS_S)
        c = dict(shape=f"{model} {name} [{m},{n}]", model=model, err=err,
                 event_ms=t, plain_ms=tp, bound_ms=bms, bound_by=by,
                 kern_us=kern_us, lib_us=lib_us, scale_us=scale_us,
                 copy_us=copy_us,
                 ms=t if kern_us is None else kern_us / 1e3,
                 library_ms=None if lib_us is None else lib_us / 1e3)
        cases.append(c)
        # (an older checkout's wrapper has no vector_width)
        vw = getattr(qz, "vector_width", None)
        print(f"   {c['shape']}: device_us={_fmt(kern_us)} "
              f"bound_us={bms * 1e3:.4f} ({by}) "
              f"quantize_per_channel_us={_fmt(lib_us)} "
              f"scales_us={_fmt(scale_us)} copy_us={_fmt(copy_us)} "
              f"event_ms={t:.4f} plain_ms={tp:.4f} "
              f"vector_width={'n/a' if vw is None else vw(x, out)} "
              f"max_abs_err={err}")
        if lib_note:
            print(f"     quantize_per_channel: {lib_note}")
        del x, xs, out, scale
    for model in dict.fromkeys(c["model"] for c in cases):
        sub = [c for c in cases if c["model"] == model]
        print(f"   sum over {model}'s {len(sub)} weights: "
              f"device_us={_fmt(_us_sum(sub, 'kern_us'))} "
              f"bound_us={sum(c['bound_ms'] for c in sub) * 1e3:.4f} "
              f"quantize_per_channel_us={_fmt(_us_sum(sub, 'lib_us'))} "
              f"scales_us={_fmt(_us_sum(sub, 'scale_us'))} "
              f"copy_us={_fmt(_us_sum(sub, 'copy_us'))} "
              f"event_ms={sum(c['event_ms'] for c in sub):.4f}")
    print("   device_us: the profiler's device time per call, each call on "
          "its own copy of the matrix (from HBM); bound: 5 bytes an element "
          "+ the scales at 3.35 TB/s; bit-exact to the plain version; "
          "library: torch.quantize_per_channel(x, scale.double(), 0, axis 1, "
          "qint8); copy_us: a device-to-device copy of x (8 bytes an "
          "element), for information; the record's ms is the device time")
    torch.cuda.empty_cache()
    return _kernel_record("quantize_apply", "src/repro_torch/csrc/quantize.cu",
                          TPU_KERNELS["quantize_apply"], cases)


def _causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a top-left-aligned causal mask keeps."""
    return sum(min(i + 1, sk) for i in range(sq))


@phase("flash_attention vs plain (the LM's prefill shape, a ragged GQA "
       "shape, a non-causal shape)")
def flash_phase(torch, gen, flush):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dev = "cuda"
    cases = []
    # (B, Sq, Sk, Hq, Hkv, hd, causal)
    for b, sq, sk, hq, hkv, hd, causal in ((4, 2048, 2048, 32, 32, 64, True),
                                           (2, 37, 37, 4, 2, 8, True),
                                           (1, 512, 512, 32, 32, 64, False)):
        q = torch.randn((b, sq, hq, hd), generator=gen).to(dev)
        k = torch.randn((b, sk, hkv, hd), generator=gen).to(dev)
        v = torch.randn((b, sk, hkv, hd), generator=gen).to(dev)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = close(torch, out, fa.flash_attention_plain(q, k, v, causal),
                    2e-5)
        t = device_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal), 20, flush)
        tp = device_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal), 5, flush)
        # the yardstick: PyTorch's fused attention on [B, H, S, hd] fp32
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        tl = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20, flush)
        pairs = _causal_pairs(sq, sk) if causal else sq * sk
        ops = 4.0 * b * hq * pairs * hd            # QK^T and PV
        nbytes = 4 * (2 * b * sq * hq * hd + 2 * b * sk * hkv * hd)
        # the kernel's design does each product three times (3xTF32) on
        # the tensor cores: that arithmetic at the dense TF32 rate
        bms, by = bound_ms(nbytes, 3.0 * ops, PEAK_TF32_OPS_S)
        simt, _ = bound_ms(nbytes, ops, PEAK_FP32_OPS_S)
        cases.append(dict(shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
                          f"hd={hd} causal={causal}", err=err, ms=t,
                          plain_ms=tp, library_ms=tl, bound_ms=bms,
                          bound_by=by))
        _print_case(cases[-1])
        print(f"     {ops / 1e9:.2f} GFLOP ({3 * ops / 1e9:.2f} as 3xTF32), "
              f"{nbytes / 1e6:.1f} MB; for information, the plain fp32 "
              f"SIMT bound: {simt:.4f} ms")
    print("   tolerance 2e-5 (abs and rel) against the plain version; "
          "bound: 3 x the products at 495 TFLOP/s dense TF32; "
          "library_ms: F.scaled_dot_product_attention fp32 on [B,H,S,hd]")
    return _kernel_record("flash_attention",
                          "src/repro_torch/csrc/flash_attention.cu",
                          TPU_KERNELS["flash_attention"], cases)


@phase("ssd vs plain (the LM's prefill shape, S not a multiple of the "
       "chunk, a split run carrying init_state)")
def ssd_phase(torch, gen, flush):
    """Bounded by the design's arithmetic: every product as 3xTF32 on the
    tensor cores at the dense TF32 rate (the fp32 SIMT bound is printed
    for information). ``device_ms`` is the profiler's device time of one
    call (its three launches), the mean of 10 back to back: the inputs
    (279 MB at the served shape) do not stay in L2."""
    from repro_torch.kernels import ssd as sd
    dev = "cuda"
    cases = []

    def inputs(b, s, h, p, n):
        x = torch.randn((b, s, h, p), generator=gen).to(dev)
        B_ = torch.randn((b, s, n), generator=gen).to(dev)
        C_ = torch.randn((b, s, n), generator=gen).to(dev)
        dt = (torch.rand((b, s, h), generator=gen) * 0.5 + 0.05).to(dev)
        A = (-(torch.rand(h, generator=gen) + 0.5)).to(dev)
        return x, B_, C_, dt, A

    # (B, S, H, P, N, chunk)
    for b, s, h, p, n, chunk in ((4, 2048, 64, 64, 64, 256),
                                 (1, 1000, 64, 64, 64, 256)):
        x, B_, C_, dt, A = inputs(b, s, h, p, n)
        q = sd.chunk_size(s, chunk)
        y, fin = sd.ssd(x, B_, C_, dt, A, chunk=chunk)
        torch.cuda.synchronize()
        y_p, fin_p = sd.ssd_plain(x, B_, C_, dt, A, None, chunk)
        err = max(close(torch, y, y_p, 1e-4), close(torch, fin, fin_p, 1e-4))
        t = device_ms(torch, lambda: sd.ssd(x, B_, C_, dt, A, chunk=chunk),
                      20, flush)
        tp = device_ms(torch, lambda: sd.ssd_plain(x, B_, C_, dt, A, None,
                                                   chunk), 5, flush)
        us = per_call_device_us(torch, [lambda: sd.ssd(
            x, B_, C_, dt, A, chunk=chunk)] * 10, show=True)
        # the work the function needs: C B^T and M x on and below each
        # chunk's diagonal (L is lower-triangular), then C state^T and
        # the state update; the full Q x Q square is printed only as
        # information (the reference forms it, the kernel does not)
        n_chunks = s // q
        ops = b * h * n_chunks * (q * (q + 1) * (n + p) + 4.0 * q * p * n)
        square = b * h * n_chunks * (2.0 * q * q * (n + p) + 4.0 * q * p * n)
        nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + h
                      + b * h * p * n)
        # the design does each product three times (3xTF32) on the tensor
        # cores: that arithmetic at the dense TF32 rate
        bms, by = bound_ms(nbytes, 3.0 * ops, PEAK_TF32_OPS_S)
        simt, _ = bound_ms(nbytes, ops, PEAK_FP32_OPS_S)
        cases.append(dict(shape=f"B={b} S={s} H={h} P={p} N={n} Q={q}",
                          err=err, ms=t, plain_ms=tp, library_ms=None,
                          bound_ms=bms, bound_by=by))
        _print_case(cases[-1])
        print(f"     device_ms={_fmt(None if us is None else us / 1e3)} "
              f"(profiler); {ops / 1e9:.2f} GFLOP on and below the "
              f"diagonal ({3 * ops / 1e9:.2f} as 3xTF32; "
              f"{square / 1e9:.2f} GFLOP over the full Q x Q square), "
              f"{nbytes / 1e6:.1f} MB; for information, the fp32 SIMT "
              f"bound: {simt:.4f} ms")
    # a split run: two halves with the carried state equal the whole run
    x, B_, C_, dt, A = inputs(4, 2048, 64, 64, 64)
    y, fin = sd.ssd(x, B_, C_, dt, A)
    half = 1024
    y1, st = sd.ssd(x[:, :half], B_[:, :half], C_[:, :half], dt[:, :half], A)
    y2, fin2 = sd.ssd(x[:, half:], B_[:, half:], C_[:, half:], dt[:, half:],
                      A, st)
    torch.cuda.synchronize()
    y2_p, fin2_p = sd.ssd_plain(x[:, half:], B_[:, half:], C_[:, half:],
                                dt[:, half:], A, st)
    err = max(close(torch, torch.cat([y1, y2], 1), y, 1e-4),
              close(torch, fin2, fin, 1e-4),
              close(torch, y2, y2_p, 1e-4), close(torch, fin2_p, fin2, 1e-4))
    print(f"   split run with init_state: max |diff| {err} against the "
          f"whole run and the plain version")
    cases[0]["err"] = max(cases[0]["err"], err)
    print("   tolerance 1e-4 (abs and rel) against the plain version; "
          "bound: 3 x the products at 495 TFLOP/s dense TF32; "
          "library_ms: none (PyTorch has no SSD scan)")
    return _kernel_record("ssd", "src/repro_torch/csrc/ssd.cu",
                          TPU_KERNELS["ssd"], cases)


@phase("profile: device time by kernel over served B=16 dispatches")
def profile_phase(torch, engine, inputs, label="untuned"):
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
    rows = device_rows(torch, prof)
    busy = sum(r[0] for r in rows) * 1e-6
    if not rows:
        print("   profiler recorded no device time: not measured")
        return None
    print(f"   {label}, {n} dispatches: wall {wall * 1e3:.3f} ms "
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
    counts = counts_with_routes(ops)
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
    # fc1 and the head (M <= 16) take the split-K kernel
    assert counts["int8_matmul:splitk"] == counts["int8_matmul"], counts
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


def _plan_kernels(engine):
    """What one program run of the engine's accel plan launches, from the
    plan itself: its quantized dense and conv nodes and its random nodes;
    and the weights calibration quantizes (every conv2d/dense node)."""
    plan = engine.planned("accel")
    ops = [qp.op for qp in plan.qplans.values()]
    return dict(
        dense=ops.count("dense"), conv=ops.count("conv2d"),
        sample=sum(n.op == "sample_normal"
                   for n in plan.graph.nodes.values()),
        quantized=sum(n.op in ("conv2d", "dense")
                      for n in engine.graph.nodes.values()),
        demoted=list(plan.demoted))


@phase("main path: serve the paper's other five networks (published "
       "widths) on accel through the scheduler")
def space_serve_phase(torch, name):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parser().parse_args([
        "--mode", "space", "--model", name, "--backend", "accel",
        "--requests", str(N_REQUESTS), "--batch", str(LADDER_TOP)])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched, trace, engines = serve.build_scheduler(args)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched.serve_trace(trace)
    counts = counts_with_routes(ops)
    wall = time.perf_counter() - t0
    tel = sched.telemetry()[name]
    engine = engines[name]
    print(sched.summary())
    runs = len(sched.dispatches) + 2 * len(serve.capped_ladder(LADDER_TOP))
    k = _plan_kernels(engine)
    # calibration's fp32 trace runs every node once a calibration request
    # on the card, the sampler among them (the launcher calibrates on 4)
    traced = 4
    print(f"   [{name}] setup (calibrate + warm-up) {setup:.2f} s; served "
          f"{tel.n_completed}/{N_REQUESTS} in {len(sched.dispatches)} "
          f"dispatches, wall {wall:.3f} s, p50 {tel.p50_latency_ms:.2f} ms, "
          f"p99 {tel.p99_latency_ms:.2f} ms")
    print(f"   plan: {k['dense']} int8 dense, {k['conv']} int8 conv, "
          f"{k['sample']} sampler node(s) a run, {runs} runs; PTQ-demoted "
          f"{k['demoted']}")
    print(f"   launch counts: {counts}")
    assert tel.n_completed == N_REQUESTS, tel.n_completed
    want = {"quantize_apply": k["quantized"],
            "int8_matmul": k["dense"] * runs,
            "int8_matmul:splitk": k["dense"] * runs,
            "conv2d_int8": k["conv"] * runs,
            "conv2d_int8_cout_blocks": 0,
            "sample_normal": k["sample"] * (runs + traced)}
    got = {n: counts[n] for n in want}
    assert got == want, (got, want)
    expected = tuple(n for n in ("int8_matmul", "conv2d_int8",
                                 "quantize_apply", "sample_normal")
                     if want[n])
    inputs = [r for _, _, r in sorted(trace, key=lambda e: e[0])]
    return sched, engine, counts, inputs, expected


@phase("served outputs of the five networks vs the port's CPU engine "
       "(plain versions, sharing weights and calibration)")
def space_reference_phase(torch, name, sched, card_engine, inputs):
    """int8 chains bit-exact (the VAE's mu and logvar; logistic_net's
    head when quantized); fp32 conv3d (cuDNN here, oneDNN there) feeding
    the int8 fc1 within the reference's accel bound, an argmax flip only
    on a fp32 top-2 margin within twice it; ESPERTA's prob to 1e-6
    relative, warn equal off the threshold; fp32 dense (a demoted layer)
    to 1e-5. The VAE's sample: one B=16 batch on both engines with the
    same keys, within 2e-6 (the served keys come from the pipeline's seed
    chain)."""
    import numpy as np
    from repro_torch.core.engine import Engine
    from repro_torch.models import esperta
    cpu = Engine(card_engine.graph,
                 {n: {k: v.cpu() for k, v in p.items()}
                  for n, p in card_engine.params.items()}, device="cpu")
    cpu.share_calibration(card_engine)
    qplans = card_engine.planned("accel").qplans
    comps = sorted(sched.completions, key=lambda c: c.rid)
    t0 = time.perf_counter()
    worst = 0.0
    for i in range(0, len(comps), BATCH):
        chunk = comps[i:i + BATCH]
        reqs = [inputs[c.rid] for c in chunk]
        batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
        want = {k: v.numpy() for k, v in cpu.run_batch(batch,
                                                       "accel").items()}
        got = {k: np.stack([c.outputs[k] for c in chunk]) for k in want}
        for k, g in got.items():
            if not np.isfinite(g.astype(np.float64)).all():
                raise AssertionError(f"{k}: non-finite outputs")
        t = {k: torch.from_numpy(v) for k, v in got.items()}
        w = {k: torch.from_numpy(v) for k, v in want.items()}
        if name == "vae_encoder":
            for k in ("mu", "logvar"):
                worst = max(worst, exact(torch, t[k], w[k]))
        elif name == "multi_esperta":
            for m in range(6):
                worst = max(worst, float(np.abs(got[f"prob{m}"]
                                                - want[f"prob{m}"]).max()))
                torch.testing.assert_close(t[f"prob{m}"], w[f"prob{m}"],
                                           rtol=1e-6, atol=0)
                off = (np.abs(want[f"prob{m}"] - esperta.THRESHOLDS[m])
                       > 1e-6)
                assert (got[f"warn{m}"][off] == want[f"warn{m}"][off]).all()
        elif name == "logistic_net" and "head" in qplans:
            worst = max(worst, exact(torch, t["head"], w["head"]))
            exact(torch, t["region"], w["region"])
        elif name == "logistic_net":
            worst = max(worst, close(torch, t["head"], w["head"], 1e-5))
            exact(torch, t["region"], w["region"])
        else:
            atol = ACCEL_ATOL[name]
            err = float(np.abs(got["head"] - want["head"]).max())
            assert err <= atol, (err, atol)
            worst = max(worst, err)
            logits = cpu.run_batch(batch, "cpu")["head"].numpy()
            for r in np.nonzero(got["region"] != want["region"])[0]:
                top = np.sort(logits[r].ravel())
                assert top[-1] - top[-2] <= 2 * atol, (r, top[-2:])
    print(f"   {len(comps)} outputs held (max |diff| {worst}); CPU "
          f"reference took {time.perf_counter() - t0:.1f} s")
    if name == "vae_encoder":
        reqs = inputs[:BATCH]
        batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
        keys = np.random.default_rng(17).integers(
            0, 2 ** 32, size=(len(reqs), 2), dtype=np.uint32)
        g = card_engine.run_batch(batch, "accel", rngs=keys)
        c = cpu.run_batch(batch, "accel", rngs=keys)
        exact(torch, g["mu"].cpu(), c["mu"])
        torch.testing.assert_close(g["sample"].cpu(), c["sample"],
                                   rtol=2e-6, atol=1e-6)
        err = float((g["sample"].cpu() - c["sample"]).abs().max())
        samples = np.stack([x.outputs["sample"] for x in comps])
        assert len(np.unique(samples, axis=0)) == len(comps), \
            "served samples repeat"
        print(f"   sample, same keys, card vs CPU: max |diff| {err}; "
              f"{len(comps)} served samples all distinct")


@phase("main path: serve the LM block at zamba2-1.2b widths on accel "
       "through the LM scheduler")
def lm_serve_phase(torch):
    from repro_torch.kernels import int8_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_model
    args = serve.parser().parse_args([
        "--mode", "lm", "--backend", "accel", "--requests",
        str(LM_REQUESTS), "--tokens", str(LM_TOKENS), "--slots",
        str(LM_SLOTS)])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched, lm = serve.build_lm_scheduler(args, lm_model.ZAMBA2_1_2B)
    setup = time.perf_counter() - t0
    calib = counts_with_routes(ops)
    print(f"   setup (weights, calibration on 8 windows, engine) {setup:.2f} "
          f"s; launches in calibration: {calib}")
    n_q = len(lm.plan.qplans)
    print(f"   {n_q} quantized node(s) (PTQ demoted {lm.plan.demoted}); "
          f"KV capacity {lm.capacity}")
    # drive the launcher's loop (LMScheduler.run) one dispatch at a time
    # to read the counters around each dispatch
    steps = []
    t0 = time.perf_counter()
    while True:
        before = counts_with_routes(ops)
        traces = lm.n_traces
        if not sched.step():
            break
        after = counts_with_routes(ops)
        kind = sched.events[-1].phase       # 'prefill' | 'decode'
        steps.append((kind, {k: after[k] - before[k] for k in after},
                      traces, lm.n_traces))
    wall = time.perf_counter() - t0
    counts = counts_with_routes(ops)
    tel = sched.telemetry()
    print(sched.summary())
    pre = [d for k, d, _, _ in steps if k == "prefill"]
    dec = [d for k, d, _, _ in steps if k == "decode"]
    print(f"   served {tel.n_completed}/{LM_REQUESTS} requests, "
          f"{tel.n_tokens} tokens in {wall:.3f} s wall: {len(pre)} prefill "
          f"dispatches (p50 {tel.prefill_p50_ms:.3f} ms each, B={LM_SLOTS} "
          f"x {lm.seq_len} positions), {len(dec)} decode steps (p50 "
          f"{tel.decode_step_p50_ms:.3f} ms each)")
    print(f"   launches per prefill {pre[0]}; per decode step {dec[0]}")
    print(f"   launch counts over the served run: "
          f"{ {k: counts[k] - calib[k] for k in counts} }")
    assert tel.n_completed == LM_REQUESTS, tel.n_completed
    assert all(len(c.tokens) == LM_TOKENS for c in sched.completions)
    assert lm.slots.in_use == 0
    # a prefill's projections (M = rung x 2048) all take the tile kernel;
    # a decode step's (M = rung <= LM_SLOTS) take the kernel the rule
    # gives at that M, which no rung <= LM_SLOTS changes
    dec_tile = sum(mm.route(LM_SLOTS, *qp.w_q.shape)
                   == "tile" for qp in lm.plan.qplans.values())
    for d in pre:
        assert d["flash_attention"] == 1 and d["ssd"] == 1, d
        assert d["int8_matmul"] == d["int8_matmul:tile"] == n_q, d
    for d in dec:
        assert d["flash_attention"] == 0 and d["ssd"] == 0, d
        assert d["int8_matmul"] == n_q, d
        assert d["int8_matmul:tile"] == dec_tile, d
        assert d["int8_matmul:splitk"] == n_q - dec_tile, d
    late = [(t0_, t1_) for k, _, t0_, t1_ in steps if k == "decode"]
    late = late[len(late) // 2:]
    assert all(t0_ == t1_ for t0_, t1_ in late), late
    for c in sched.completions:
        assert all(0 <= t < lm_model.ZAMBA2_1_2B.vocab for t in c.tokens)
    return sched, lm, counts


def _head_logits(torch, lm, hidden):
    """The vocab head on ``hidden`` [R, D], as the decode program computes
    it (the same quantized-node call on the same weights)."""
    from repro_torch.core.plan import _run_quantized
    plan = lm.plan
    x = torch.as_tensor(hidden, device=lm.device)
    with torch.no_grad():
        return _run_quantized(plan.qplans["head"], x,
                              packed=plan.packed.get("head"),
                              w_q=plan.weight_arena["head"]).cpu()


@phase("LM reference: one request, prefill + 4 decode steps, card vs the "
       "port's CPU engine at full width")
def lm_reference_phase(torch, lm):
    """Request 0's prompt through a fresh LMEngine on the card and one on
    the CPU (same weights and calibration). Each decode step feeds both
    engines the CPU's feedback features, so a step's difference is that
    step's own and cannot compound through the feedback loop."""
    import numpy as np
    from repro_torch.core.engine import Engine
    from repro_torch.core.lm import LMEngine
    served = lm.engine
    card = Engine(served.graph, served.params, device=served.device)
    cpu = Engine(served.graph, {n: {k: v.cpu() for k, v in p.items()}
                                for n, p in served.params.items()},
                 device="cpu")
    for e in (card, cpu):
        e.share_calibration(served)
    lms = {name: LMEngine(e, "accel", n_slots=1,
                          max_new_tokens=LM_REF_STEPS + 1)
           for name, e in (("card", card), ("cpu", cpu))}
    x = np.random.default_rng(7).normal(
        size=(1, lm.seq_len, lm.d_model)).astype(np.float32) * 0.5
    slot = np.zeros(1, np.int32)
    seconds = dict.fromkeys(lms, 0.0)

    def run(name, step):
        t0 = time.perf_counter()
        res = step(lms[name])
        out = (res, _head_logits(torch, lms[name], res.hidden))
        seconds[name] += time.perf_counter() - t0
        return out

    steps = [{n: run(n, lambda e: e.prefill(x, slot)) for n in lms}]
    for w in ("k_codes", "k_scale", "v_codes", "v_scale"):
        exact(torch, lms["card"].caches["attn"][w][0, :lm.seq_len].cpu(),
              lms["cpu"].caches["attn"][w][0, :lm.seq_len])
    print("   prefill K/V cache codes and f16 scales: bit-exact")
    # the SSD state the commit cached: the kernel's final state
    err = close(torch, lms["card"].caches["ssm"]["state"][0].cpu(),
                lms["cpu"].caches["ssm"]["state"][0], 1e-4)
    print(f"   prefill SSD cache state (the ssd kernel's final state): "
          f"max |diff| {err:.3g} card vs CPU, within 1e-4")
    for _ in range(LM_REF_STEPS):
        hidden = steps[-1]["cpu"][0].hidden
        steps.append({n: run(n, lambda e: e.decode_step(hidden, slot))
                      for n in lms})
    print(f"   prefill + {LM_REF_STEPS} decode steps: card "
          f"{seconds['card']:.1f} s, CPU {seconds['cpu']:.1f} s")
    st = [lms[n].caches["ssm"]["state"][0].cpu() for n in ("card", "cpu")]
    print(f"   SSD cache state after the steps: max |diff| "
          f"{float((st[0] - st[1]).abs().max()):.3g}")
    worst, bad = 0.0, []
    for i, step in enumerate(steps):
        (res_g, lg_g), (res_c, lg_c) = step["card"], step["cpu"]
        e_l = float((lg_g - lg_c).abs().max())
        e_h = float(np.abs(res_g.hidden - res_c.hidden).max())
        top2 = torch.topk(lg_c[0], 2).values
        margin = float(top2[0] - top2[1])
        tg, tc = int(res_g.tokens[0]), int(res_c.tokens[0])
        print(f"   step {i}: logits max |diff| {e_l:.3g} (|logits| <= "
              f"{float(lg_c.abs().max()):.3g}), resid2 max |diff| {e_h:.3g}, "
              f"token card {tg} cpu {tc} (CPU top-2 margin {margin:.3g})")
        if not (np.isfinite(res_g.hidden).all()
                and bool(torch.isfinite(lg_g).all())):
            bad.append(f"step {i}: non-finite")
        if margin > 2 * LM_LOGITS_ATOL and tg != tc:
            bad.append(f"step {i}: tokens differ")
        worst = max(worst, e_l, e_h)
    assert worst <= LM_LOGITS_ATOL and not bad, (worst, bad)
    print(f"   logits and resid2 within {LM_LOGITS_ATOL} (worst {worst:.3g})")


@phase("profile: device time by kernel over one B=4 LM prefill and one "
       "decode step")
def lm_profile_phase(torch, lm):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    x = np.random.default_rng(11).normal(
        size=(LM_SLOTS, lm.seq_len, lm.d_model)).astype(np.float32) * 0.5
    ids = [f"profile{i}" for i in range(LM_SLOTS)]
    slots = np.array([lm.assign_slot(r) for r in ids], np.int32)
    res = lm.prefill(x, slots)                  # warm both programs
    lm.decode_step(res.hidden, slots)
    out = {}
    for kind in ("prefill", "decode"):
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if kind == "prefill":
                    res = lm.prefill(x, slots)
                else:
                    lm.decode_step(res.hidden, slots)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        except RuntimeError as e:        # the tracer itself, not the port
            print(f"   torch.profiler failed ({e}): not measured")
            break
        rows = device_rows(torch, prof)
        busy = sum(r[0] for r in rows) * 1e-6
        if not rows:
            print(f"   {kind}: profiler recorded no device time: "
                  f"not measured")
            continue
        n_launch = sum(r[1] for r in rows)
        print(f"   one {kind} (B={LM_SLOTS}): wall {wall * 1e3:.3f} ms, "
              f"device busy {busy * 1e3:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}, {n_launch} device events")
        for dev_us, count, key in rows[:12]:
            print(f"   {dev_us / 1e3:9.4f} ms  x{count:<5d} {key[:70]}")
        if kind == "prefill":
            # the commit caches the kernel's state: no per-position scan
            # (which launched an exp per position, 2048 a prefill)
            n_exp = sum(ev.count for ev in prof.key_averages()
                        if ev.key == "aten::exp")
            print(f"   aten::exp calls in the prefill: {n_exp}")
            assert n_exp < 64, n_exp
        out[kind] = busy
    for r in ids:
        lm.release_slot(r)
    return out


@phase("main path: serve cnet_plus_scalar (full width) on accel with "
       "--autotune --tuning-cache, then a second engine over the warm cache")
def tuned_serve_phase(torch, sched0, cache_path):
    """The same trace as serve_phase through the plan-time autotuner: each
    request's output must equal the untuned served output bit for bit
    (those are held against the CPU engine already). Per dispatch the
    tuned plan launches the stem's channel-blocked conv once."""
    import numpy as np
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parser().parse_args([
        "--mode", "space", "--model", "cnet_plus_scalar", "--backend",
        "accel", "--requests", str(N_REQUESTS), "--batch", str(LADDER_TOP),
        "--autotune", "--tuning-cache", cache_path])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched, trace, engines = serve.build_scheduler(args)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched.serve_trace(trace)
    counts = counts_with_routes(ops)
    wall = time.perf_counter() - t0
    engine = engines["cnet_plus_scalar"]
    tel = sched.telemetry()["cnet_plus_scalar"]
    plan = engine.planned("accel")
    print("\n".join(plan.autotune_lines()))
    print(f"   tuner stats {engine.tuner.stats}; cache {cache_path} holds "
          f"{len(engine.tuner.cache)} entries")
    n_disp = len(sched.dispatches)
    n_warm = 2 * len(serve.capped_ladder(LADDER_TOP))
    print(f"   setup (calibrate + tune + warm-up) {setup:.2f} s; served "
          f"{tel.n_completed}/{N_REQUESTS} requests in {n_disp} dispatches, "
          f"wall {wall:.3f} s, p50 {tel.p50_latency_ms:.2f} ms, "
          f"p99 {tel.p99_latency_ms:.2f} ms")
    print(f"   launch counts: {counts}")
    assert tel.n_completed == N_REQUESTS, tel.n_completed
    n = n_warm + n_disp
    assert counts["conv2d_int8_cout_blocks"] == n, counts
    assert counts["conv2d_int8"] == 2 * n, counts
    assert counts["int8_matmul"] == 2 * n, counts
    assert counts["int8_matmul:splitk"] == 2 * n, counts
    assert counts["quantize_apply"] == 5, counts
    assert plan.packed["act0"].cout_per_block == 16, plan.packed["act0"]
    assert (plan.packed["fc1_act"].bk, plan.packed["fc1_act"].bn) == \
        (1024, 96)
    assert tuple(plan.weight_arena["fc1_act"].shape) == (33792, 96)
    assert tuple(plan.weight_arena["head"].shape) == (96, 8)
    want = {c.rid: c.outputs["head"] for c in sched0.completions}
    got = {c.rid: c.outputs["head"] for c in sched.completions}
    assert sorted(got) == sorted(want) == list(range(N_REQUESTS))
    worst = max(float(np.abs(got[r].astype(np.float64) - want[r]).max())
                for r in got)
    for r in got:
        assert got[r].dtype == want[r].dtype
        assert np.array_equal(got[r], want[r]), (r, worst)
    print(f"   {N_REQUESTS} outputs bit-identical to the untuned served "
          f"outputs (max |diff| {worst})")
    # a second engine over the saved cache: no candidate is priced again
    warm = Engine(engine.graph, engine.params, device=engine.device,
                  autotune=True, tuning_cache=cache_path)
    warm.share_calibration(engine)
    for rung in serve.capped_ladder(LADDER_TOP):
        warm.compile("accel", rung)
    stats = warm.tuner.stats
    print(f"   warm-cache engine: tuner stats {stats}")
    assert stats["evaluated"] == 0, stats
    assert stats["cache_hits"] == stats["nodes"] > 0, stats
    return sched, engine, counts


@phase("--autotune-measure: a CNet engine whose tuner times its top "
       "picks on the card, one B=16 dispatch against the served outputs")
def measured_tune_phase(torch, sched0, engine0, inputs):
    """The opt-in measured refinement, driven once on the card: only the
    convs' channel blocking changes the launch, so only the conv nodes are
    timed. Whatever it picks, the outputs must equal the untuned served
    ones bit for bit. Not part of any served path's launch counts."""
    import numpy as np
    from repro_torch.core.engine import Engine
    e = Engine(engine0.graph, engine0.params, device=engine0.device,
               autotune=True, autotune_measure=True)
    e.share_calibration(engine0)
    reqs = inputs[:BATCH]
    batch = {k: np.stack([r[k] for r in reqs]) for k in reqs[0]}
    t0 = time.perf_counter()
    got = e.run_batch(batch, "accel")["head"]
    tune_s = time.perf_counter() - t0
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    plan = e.planned("accel")
    print("\n".join(plan.autotune_lines()))
    print(f"   tuner stats {e.tuner.stats}; lowering (tuning, timing) and "
          f"the first dispatch {tune_s:.2f} s")
    # the packing rung chooses the layouts by measurement; the B=16 rung
    # is pinned to them, so its conv nodes have no launch left to time
    decs = [d for t in plan._tuning.values() for d in t.values()]
    assert e.tuner.stats["measured"] > 0, e.tuner.stats
    assert any(d.source == "measured" for d in decs
               if d.kind == "int8_conv"), decs
    assert all(d.source == "model" for d in decs
               if d.kind == "int8_dense"), decs
    want = {c.rid: c.outputs["head"] for c in sched0.completions}
    for i in range(BATCH):
        assert np.array_equal(got[i], want[i]), i
    print(f"   {BATCH} outputs bit-identical to the untuned served outputs")


def _lm_steps(torch, lm, x, feed):
    """Prefill ``x`` into slot 0, then one decode step per feature row of
    ``feed`` (or of the engine's own output when ``feed`` is None); the
    (result, vocab logits) of each step and the launch counts."""
    import numpy as np
    from repro_torch.kernels import ops
    slot = np.zeros(1, np.int32)
    ops.reset_launch_counts()
    results = [lm.prefill(x, slot)]
    for i in range(LM_REF_STEPS):
        hidden = feed[i] if feed is not None else results[-1].hidden
        results.append(lm.decode_step(hidden, slot))
    torch.cuda.synchronize()
    counts = counts_with_routes(ops)
    return [(r, _head_logits(torch, lm, r.hidden)) for r in results], counts


@phase("main path: the LM block at zamba2-1.2b widths with --autotune, one "
       "request (prefill + 4 decode steps) against the untuned engine")
def lm_tuned_phase(torch, lm):
    """Two fresh LMEngines on the card over the served engine's weights and
    calibration (shared, not redone): one untuned, one autotuned. Both
    decode from the untuned engine's feedback features, so a step's
    difference is that step's own."""
    import numpy as np
    from repro_torch.core.engine import Engine
    from repro_torch.core.lm import LMEngine
    served = lm.engine
    lms = {}
    for name, tune in (("untuned", False), ("tuned", True)):
        e = Engine(served.graph, served.params, device=served.device,
                   autotune=tune)
        e.share_calibration(served)
        lms[name] = LMEngine(e, "accel", n_slots=1,
                             max_new_tokens=LM_REF_STEPS + 1)
    x = np.random.default_rng(7).normal(
        size=(1, lm.seq_len, lm.d_model)).astype(np.float32) * 0.5
    base, _ = _lm_steps(torch, lms["untuned"], x, None)
    feed = [r.hidden for r, _ in base[:-1]]
    steps, counts = _lm_steps(torch, lms["tuned"], x, feed)
    plan = lms["tuned"].plan
    print("\n".join(plan.autotune_lines()))
    print(f"   launch counts (prefill + {LM_REF_STEPS} decode steps): "
          f"{counts}")
    n_q = len(plan.qplans)
    assert counts["flash_attention"] == 1 and counts["ssd"] == 1, counts
    assert counts["int8_matmul"] == n_q * (1 + LM_REF_STEPS), counts
    # the prefill's packed projections (M = 2048, ldw = np) take the tile
    # kernel
    assert counts["int8_matmul:tile"] >= n_q, counts
    assert plan.packed and all(plan.weight_arena[n] is plan.packed[n].w_q
                               for n in plan.qplans)
    for w in ("k_codes", "k_scale", "v_codes", "v_scale"):
        exact(torch, lms["tuned"].caches["attn"][w][0, :lm.seq_len].cpu(),
              lms["untuned"].caches["attn"][w][0, :lm.seq_len].cpu())
    print("   prefill K/V cache codes and f16 scales: bit-exact to untuned")
    worst, bad = 0.0, []
    for i, ((res_t, lg_t), (res_u, lg_u)) in enumerate(zip(steps, base)):
        e_l = float((lg_t - lg_u).abs().max())
        e_h = float(np.abs(res_t.hidden - res_u.hidden).max())
        top2 = torch.topk(lg_u[0], 2).values
        margin = float(top2[0] - top2[1])
        tt, tu = int(res_t.tokens[0]), int(res_u.tokens[0])
        print(f"   step {i}: logits max |diff| {e_l:.3g}, resid2 max |diff| "
              f"{e_h:.3g}, token tuned {tt} untuned {tu} (top-2 margin "
              f"{margin:.3g})")
        if not (np.isfinite(res_t.hidden).all()
                and bool(torch.isfinite(lg_t).all())):
            bad.append(f"step {i}: non-finite")
        if margin > 2 * LM_LOGITS_ATOL and tt != tu:
            bad.append(f"step {i}: tokens differ")
        worst = max(worst, e_l, e_h)
    assert worst <= LM_LOGITS_ATOL and not bad, (worst, bad)
    print(f"   logits and resid2 within {LM_LOGITS_ATOL} (worst {worst:.3g})")
    return counts


def only(torch, src: Path, phases, kernels=None) -> int:
    """Build ``src``'s kernels (``kernels``: those named, else all) and run
    ``phases`` only (a phase's extra arguments ride in a tuple beside
    it)."""
    records = []
    if build_phase(kernels) is not None:
        gen = torch.Generator().manual_seed(0)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for ph, *extra in phases:
            rec = ph(torch, gen, flush, *extra)
            if isinstance(rec, list):
                records.extend(rec)
            elif rec is not None:
                records.append(rec)
    print(json.dumps({"kernels": records, "src": str(src)}), flush=True)
    print(gpu_line(), flush=True)
    if FAILURES:
        print(f"FAILED phases: {FAILURES}", flush=True)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--conv-only", nargs="?", const=str(SRC), metavar="SRC",
                    help="build SRC's kernels (a checkout's src/, this "
                    "one's by default) and run only the conv phases")
    ap.add_argument("--ssd-splitk-only", nargs="?", const=str(SRC),
                    metavar="SRC", help="the same for the ssd phase and "
                    "int8_matmul's split-K shapes")
    ap.add_argument("--quantize-only", nargs="?", const=str(SRC),
                    metavar="SRC", help="the same for the quantize phase "
                    "(builds quantize_apply alone)")
    args = ap.parse_args()
    picked = args.conv_only or args.ssd_splitk_only or args.quantize_only
    src = SRC if picked is None else Path(picked).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke.py: {src}/repro_torch not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.conv_only is not None:
        return only(torch, src, [(conv_phase,), (conv_blocks_phase,),
                                 (conv_f32_phase,)])
    if args.ssd_splitk_only is not None:
        return only(torch, src, [(ssd_phase,), (matmul_phase, "splitk")])
    if args.quantize_only is not None:
        return only(torch, src, [(quantize_phase,)], ["quantize_apply"])

    records = []
    if build_phase() is not None:
        gen = torch.Generator().manual_seed(0)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for ph in (matmul_phase, conv_phase, conv_blocks_phase,
                   quantize_phase, flash_phase, ssd_phase, conv_f32_phase,
                   sample_phase):
            rec = ph(torch, gen, flush)
            if isinstance(rec, list):
                records.extend(rec)
            elif rec is not None:
                records.append(rec)
        route_phase(torch, gen, flush)
        del flush
        torch.cuda.empty_cache()
        paths = {}                      # served path -> its launch counts
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            served = serve_phase(torch)
            if served is not None:
                sched, engine, counts, inputs = served
                paths["cnet_plus_scalar"] = (CNN_KERNELS, counts)
                reference_phase(torch, sched, engine, inputs)
                tuned = tuned_serve_phase(torch, sched,
                                          str(tmp / "tuning.json"))
                measured_tune_phase(torch, sched, engine, inputs)
                profile_phase(torch, engine, inputs)
                if tuned is not None:
                    _, tuned_engine, counts = tuned
                    paths["cnet_plus_scalar --autotune"] = (
                        TUNED_CNN_KERNELS, counts)
                    profile_phase(torch, tuned_engine, inputs, "autotuned")
                del sched, engine, inputs, tuned
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for name in SPACE_MODELS:
            served = space_serve_phase(torch, name)
            if served is None:
                continue
            sched, engine, counts, inputs, expected = served
            paths[name] = (expected, counts)
            space_reference_phase(torch, name, sched, engine, inputs)
            if name in ("baseline_net", "vae_encoder"):
                profile_phase(torch, engine, inputs, name)
            del sched, engine, inputs
            torch.cuda.empty_cache()
        served = lm_serve_phase(torch)
        if served is not None:
            sched, lm, counts = served
            paths["lm"] = (LM_KERNELS, counts)
            lm_reference_phase(torch, lm)
            lm_profile_phase(torch, lm)
            counts = lm_tuned_phase(torch, lm)
            if counts is not None:
                paths["lm --autotune"] = (TUNED_LM_KERNELS, counts)
        if len(paths) != 4 + len(SPACE_MODELS):
            FAILURES.append("a served path failed")
        for path, (names, counts) in paths.items():
            print(f"launches on the {path} path: {counts}")
            FAILURES.extend(f"{n} never launched on the {path} path"
                            for n in names if counts[n] == 0)
        for rec in records:
            rec["launches"] = sum(c[rec["name"]] for _, c in paths.values())
    # every pallas_call has a record, and every kernel with none behind it
    covered = {r["replaces"] for r in records
               if r["name"] not in OTHER_KERNELS}
    if covered != set(TPU_KERNELS.values()):
        FAILURES.append(f"kernel records cover {len(covered)} of the "
                        f"{len(TPU_KERNELS)} TPU kernels")
    missing = set(OTHER_KERNELS) - {r["name"] for r in records}
    if missing:
        FAILURES.append(f"no kernel record for {sorted(missing)}")
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
