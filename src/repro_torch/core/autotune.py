"""Plan-time kernel autotuner + prepacked weight arenas.

The paper's DPU/HLS gap is a *schedule* gap: the DPU compiler picks tile
shapes per layer and keeps weights resident in a packed on-chip layout,
while the naive HLS designs fix one unsearched schedule per network. This
module moves both decisions to plan time, as the reference does:

* **Autotuner** — at ``ExecutionPlan.lower()`` time, enumerate candidate
  tile configs per (op, shape, dtype, backend, batch rung), price each
  with a kernel-level refinement of the ``core/energy.py`` roofline
  (padded-tile MACs at the backend's sustained rate, a per-grid-step
  sequencer overhead ``HardwareModel.grid_step_s``, and weight restream
  traffic when the packed weights don't fit on-chip), optionally refine
  the top-K by timing the port's kernels, and persist winners to a JSON
  tuning cache keyed by a stable config hash — repeat lowerings never
  re-search. The heuristic default is always candidate #0, so a tuned
  pick is never worse than the default under the same pricer.

* **Prepacked weight arenas** — tile-alignment padding and neutral
  scale/bias extension move out of the per-call kernel wrappers into one
  plan-time prepack producing device-resident, tile-aligned tensors
  (:class:`PackedDense`/:class:`PackedConv`) that the kernels consume
  directly (``prepacked=True`` / ``cout_per_block`` paths);
  ``core/memory.py`` residency and ``energy.weight_bytes`` charge the
  packed (padded) footprint.

The pricers model the paper's accelerator analogs (``energy.BACKEND_HW``:
the ZCU104 DPU and HLS fabric), not the CUDA card the port runs on, and are
the reference's unchanged, so the port's picks equal the reference's pick
for pick. On the card the picks are schedule choices the CUDA kernels honour
where they have the knob (``cout_per_block`` selects the channel-blocked
conv grid; packed layouts are read in place) and otherwise leave their own
fixed tiles in place.

Search spaces per kernel kind:

* ``int8_dense`` (accel) — (bm, bn, bk) tile blocks; candidates are
  8-aligned clamps of {8..1024} per dim, on-chip-feasible only.
* ``int8_conv`` (accel) — rows-per-block (output-row tiling) and
  cout-per-block (output-channel tiling; smaller on-chip weight slice,
  more grid steps).
* ``attention`` / ``ssd`` (LM, either backend) — flash-attention (bq, bk)
  blocks and the SSD scan's chunk length.
* ``hls`` (flex) — the dataflow unroll factor the paper's naive HLS
  designs never searched (it prices the flex analog only; execution is
  unchanged).

Bit-exactness: integer accumulation is associative and padding lanes are
exact zeros (neutral 1.0 scales / 0.0 biases), so every candidate config —
and the prepacked path — produces bit-identical int8/fp32 outputs to the
heuristic default; the flex configs don't touch execution at all.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import energy as energy_mod
from repro_torch.core.opgraph import base_op
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv2d import conv_geometry
from repro_torch.kernels.epilogue import pad_channel_params
from repro_torch.kernels.int8_matmul import heuristic_blocks

SCHEMA_VERSION = 1

# candidate pools (clamped/filtered per shape; deterministic order)
DENSE_TILES = (8, 16, 32, 64, 128, 256, 512, 1024)
CONV_ROWS = (1, 2, 4, 8, 16, 32, 64, 128)
CONV_COUT_BLOCKS = (8, 16, 32, 64)
HLS_UNROLLS = (1, 2, 4, 8, 16, 32, 64)
HLS_MAX_UNROLL = 64           # DSP-lane budget of the flex dataflow analog
DEFAULT_CONV_ROWS = 8         # the pre-autotune kernel default
INT8_KINDS = ("int8_dense", "int8_conv")
# LM kernel pools: flash-attention q/k block shapes and the SSD scan's
# chunk length. 256 is the shipped kernel default.
ATTN_BLOCKS = (64, 128, 256, 512)
DEFAULT_ATTN_BLOCK = 256
SSD_CHUNKS = (32, 64, 128, 256, 512)
DEFAULT_SSD_CHUNK = 256


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Configs and decisions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in a kernel's schedule space. Unused fields stay at
    their zero/identity defaults (a dense config has no rows_per_block;
    an hls config only has unroll)."""
    bm: int = 0
    bn: int = 0
    bk: int = 0                   # dense reduction block / attention K block
    rows_per_block: int = 0
    cout_per_block: int = 0       # 0 = whole Cout per grid step
    unroll: int = 1
    bq: int = 0                   # attention query block
    chunk: int = 0                # SSD scan chunk length

    def to_dict(self) -> Dict[str, int]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v not in (0, None)} or {"unroll": 1}

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "KernelConfig":
        return cls(**{k: int(v) for k, v in d.items()})


@dataclasses.dataclass(frozen=True)
class TuningDecision:
    """The autotuner's verdict for one node at one batch rung."""
    kind: str                     # 'int8_dense' | 'int8_conv' | 'hls'
    config: KernelConfig
    modeled_s: float              # whole-batch kernel time, chosen config
    default_s: float              # same pricer, heuristic default config
    extra_bytes: float = 0.0      # weight restream DDR traffic (non-resident)
    source: str = "model"         # 'model' | 'measured' | 'cache'

    @property
    def speedup(self) -> float:
        return self.default_s / max(self.modeled_s, 1e-30)


# ---------------------------------------------------------------------------
# Tuning cache (JSON, keyed by a stable config hash)
# ---------------------------------------------------------------------------


def cache_key(kind: str, sig: Tuple, backend: str, hw,
              fixed: Optional[KernelConfig] = None,
              resident: bool = True, measured: bool = False) -> str:
    """Stable key for one (op, shape, dtype, backend, batch-rung) search:
    shape signature + backend hardware constants the pricer reads +
    search-space schema version + any fixed-layout constraint + the
    plan's weight-residency flag (an input to the restream pricing) +
    whether the measured refinement ran (wall-clock winners may differ
    from model winners and must never be served into model-only runs).
    Anything that could change the winner — or the stored prices —
    changes the key, so a stale cache can never serve a pick the current
    pricer wouldn't make."""
    payload = {
        "v": SCHEMA_VERSION,
        "kind": kind,
        "sig": list(sig),
        "backend": backend,
        "hw": [hw.name, hw.peak_ops_int8, hw.peak_flops_f32, hw.util,
               hw.grid_step_s, hw.onchip_bytes, hw.hbm_bw],
        "fixed": sorted(fixed.to_dict().items()) if fixed else None,
        "resident": bool(resident),
        "measured": bool(measured),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:20]


class TuningCache:
    """Persistent winner store: key -> {config, modeled_s, default_s,
    extra_bytes, source}. ``path=None`` keeps it in-memory (one engine's
    repeat lowerings still skip re-search); with a path, winners survive
    processes — the CI/serve warm-start contract."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, Dict[str, Any]] = {}
        self._dirty = False
        if path is not None and os.path.exists(path):
            self.load()

    def load(self) -> None:
        """Load winners from ``path``. A cache file is an OPTIMIZATION,
        never a correctness input: unreadable, truncated, or
        stale-schema files degrade to a cold cache with a one-line
        warning — a corrupt cache must not crash the serve entrypoint
        (it re-searches and rewrites the file on save)."""
        self.entries = {}
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as ex:
            print(f"[autotune] ignoring unreadable tuning cache "
                  f"{self.path}: {ex} (cold cache)")
            return
        if (not isinstance(payload, dict)
                or payload.get("version") != SCHEMA_VERSION
                or not isinstance(payload.get("entries", {}), dict)):
            # schema moved on: discard rather than mis-serve old picks
            print(f"[autotune] ignoring stale/foreign tuning cache "
                  f"{self.path} (cold cache)")
            return
        self.entries = payload.get("entries", {})

    def save(self) -> None:
        if self.path is None or not self._dirty:
            return
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": SCHEMA_VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        self._dirty = False

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self.entries.get(key)

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        self.entries[key] = entry
        self._dirty = True

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# Kernel-level pricers (the cost-model refinement of core/energy.py)
# ---------------------------------------------------------------------------


def price_int8_dense(hw, m: int, k: int, n: int, bm: int, bn: int, bk: int,
                     resident: bool) -> Tuple[float, float, bool]:
    """(seconds, restream_bytes, feasible) for one whole-batch [m,k]x[k,n]
    int8 matmul under blocks (bm, bn, bk). The MXU computes PADDED tiles
    (zero lanes occupy the array like real ones — the alignment waste the
    heuristic can't see), each grid step costs one sequencer dispatch,
    and non-resident weights restream once per M-block beyond the first."""
    mp, kp, np_ = _ceil_to(m, bm), _ceil_to(k, bk), _ceil_to(n, bn)
    vmem = bm * bk + bk * bn + 4 * bm * bn + 4 * (bm + 2 * bn)
    feasible = vmem <= hw.onchip_bytes
    t = 2.0 * mp * kp * np_ / (hw.peak_ops_int8 * hw.util)
    steps = (mp // bm) * (np_ // bn) * (kp // bk)
    t += steps * hw.grid_step_s
    restream = 0.0 if resident else (mp // bm - 1) * float(kp * np_)
    return t, restream, feasible


def price_int8_conv(hw, batch: int, h: int, w: int, cin: int, kh: int,
                    kw: int, cout: int, stride: int, padding: str,
                    rows: int, bc: int, resident: bool
                    ) -> Tuple[float, float, bool]:
    """(seconds, restream_bytes, feasible) for a whole-batch int8
    shift-and-matmul conv at (rows_per_block, cout_per_block). Padded
    output rows (row-block coverage) and padded channels compute like
    real ones; each (sample, row-block, channel-block) grid step costs
    one sequencer dispatch; the VMEM working set is the resident image +
    one weight/output slice."""
    g = conv_geometry(h, w, kh, kw, stride, padding, rows)
    bc_eff = bc or _ceil_to(cout, 8)
    cout_pad = _ceil_to(cout, bc_eff)
    h_out_pad = g.n_row_blocks * g.rows
    macs = h_out_pad * g.w_out * cout_pad * kh * kw * cin
    t = 2.0 * macs * batch / (hw.peak_ops_int8 * hw.util)
    steps = batch * g.n_row_blocks * (cout_pad // bc_eff)
    t += steps * hw.grid_step_s
    vmem = (g.h_pad * g.w_pad * cin            # int8 image, resident
            + kh * kw * cin * bc_eff           # int8 weight slice
            + g.rows * g.w_out * bc_eff * 4    # fp32 output tile
            + 8 * bc_eff)                      # scale + bias
    feasible = vmem <= hw.onchip_bytes
    restream = (0.0 if resident
                else max(batch * g.n_row_blocks - 1, 0)
                * float(kh * kw * cin * cout_pad))
    return t, restream, feasible


def price_attention(hw, batch: int, sq: int, sk: int, hq: int, hkv: int,
                    hd: int, causal: bool, bq: int, bk: int
                    ) -> Tuple[float, float, bool]:
    """(seconds, kv_restream_bytes, feasible) for one whole-batch flash
    attention at blocks (bq, bk). Padded blocks compute like real ones;
    fully-masked causal blocks short-circuit (no MXU work) but still pay
    their sequencer dispatch; every query block beyond the first
    re-streams the K/V planes (the online-softmax scratch keeps only the
    running stats resident) — larger bq trades VMEM for fewer K/V
    passes, exactly the knob worth searching."""
    bq, bk = min(bq, _ceil_to(sq, 8)), min(bk, _ceil_to(sk, 8))
    sq_p, sk_p = _ceil_to(sq, bq), _ceil_to(sk, bk)
    n_q, n_kb = sq_p // bq, sk_p // bk
    blocks = sum(1 for i in range(n_q) for j in range(n_kb)
                 if not causal or j * bk <= i * bq + bq - 1)
    flops_per_block = 4 * bq * bk * hd + 5 * bq * bk
    t = batch * hq * blocks * flops_per_block / (hw.peak_flops_f32 * hw.util)
    t += batch * hq * n_q * n_kb * hw.grid_step_s
    # f32 working set: q/acc blocks + k/v blocks + running stats
    vmem = 4 * (2 * bq * hd + 2 * bk * hd + 2 * bq)
    feasible = vmem <= hw.onchip_bytes
    restream = (batch * hq * max(n_q - 1, 0)
                * 2.0 * sk_p * hd * 4)
    return t, restream, feasible


def price_ssd(hw, batch: int, s: int, h: int, p: int, n: int, chunk: int
              ) -> Tuple[float, float, bool]:
    """(seconds, 0, feasible) for one whole-batch chunked SSD scan. Work
    is chunk-independent (the recurrence is sequential over chunks); the
    chunk length trades per-chunk sequencer dispatches against the VMEM
    slice of inputs resident per grid step."""
    chunk = max(min(chunk, s), 1)
    flops = 7.0 * s * h * p * n            # 2 contractions + decay/blend
    t = batch * flops / (hw.peak_flops_f32 * hw.util)
    t += batch * -(-s // chunk) * hw.grid_step_s
    # f32 working set: state [h,p,n] + one chunk of x/B/C/dt + y chunk
    vmem = 4 * (h * p * n + chunk * (2 * h * p + 2 * n + h))
    feasible = vmem <= hw.onchip_bytes
    return t, 0.0, feasible


def price_hls(hw, batch: int, ops_per_sample: int, reduction: int,
              unroll: int) -> Tuple[float, float, bool]:
    """(seconds, 0, feasible) for one flex-analog dataflow layer at
    ``unroll`` parallel MACs/cycle. This is the synthesis-time schedule
    knob the paper's naive HLS designs pinned at 1: unroll is capped by
    the layer's reduction depth (the adder tree can't be wider than the
    dot product) and the DSP-lane budget. It changes the MODEL only —
    the flex backend's execution (XLA) is identical for every config."""
    feasible = unroll <= min(HLS_MAX_UNROLL, max(int(reduction), 1))
    t = ops_per_sample * batch / (hw.peak_flops_f32 * hw.util * unroll)
    return t, 0.0, feasible


# ---------------------------------------------------------------------------
# Candidate enumeration (deterministic; heuristic default is candidate #0)
# ---------------------------------------------------------------------------


def _al8(d: int) -> int:
    return _ceil_to(max(int(d), 1), 8)


def dense_candidates(m: int, k: int, n: int,
                     fixed: Optional[KernelConfig] = None
                     ) -> List[KernelConfig]:
    default = KernelConfig(*heuristic_blocks(m, k, n))
    if fixed is not None:
        # packed layout pins the weight dims (bn, bk); only the
        # activation block bm is free per rung
        bms = sorted({min(t, _al8(m)) for t in DENSE_TILES})
        out = [dataclasses.replace(default, bn=fixed.bn, bk=fixed.bk)]
        out += [KernelConfig(bm, fixed.bn, fixed.bk) for bm in bms]
    else:
        bms = sorted({min(t, _al8(m)) for t in DENSE_TILES})
        bns = sorted({min(t, _al8(n)) for t in DENSE_TILES})
        bks = sorted({min(t, _al8(k)) for t in DENSE_TILES})
        out = [default] + [KernelConfig(bm, bn, bk)
                           for bm in bms for bn in bns for bk in bks]
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def conv_candidates(h_out: int, cout: int,
                    fixed: Optional[KernelConfig] = None
                    ) -> List[KernelConfig]:
    default = KernelConfig(rows_per_block=DEFAULT_CONV_ROWS)
    rows_cands = sorted({r for r in CONV_ROWS if r <= h_out} | {h_out})
    if fixed is not None:
        bcs = [fixed.cout_per_block]
        out = [dataclasses.replace(default,
                                   cout_per_block=fixed.cout_per_block)]
    else:
        bcs = [0] + sorted(c for c in CONV_COUT_BLOCKS if c < _al8(cout))
        out = [default]
    out += [KernelConfig(rows_per_block=r, cout_per_block=bc)
            for r in rows_cands for bc in bcs]
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def hls_candidates(reduction: int) -> List[KernelConfig]:
    return [KernelConfig(unroll=u) for u in HLS_UNROLLS
            if u <= min(HLS_MAX_UNROLL, max(int(reduction), 1))]


def attention_candidates(sq: int, sk: int) -> List[KernelConfig]:
    """Flash-attention (bq, bk) pool. The kernel pads ragged lengths up
    to the block grid, so every pool entry is runnable; candidate #0 is
    the shipped kernel default (clamped, like the kernel clamps)."""
    default = KernelConfig(bq=min(DEFAULT_ATTN_BLOCK, sq),
                           bk=min(DEFAULT_ATTN_BLOCK, sk))
    out = [default] + [
        KernelConfig(bq=bq, bk=bk)
        for bq in sorted({min(t, sq) for t in ATTN_BLOCKS})
        for bk in sorted({min(t, sk) for t in ATTN_BLOCKS})]
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def ssd_candidates(s: int) -> List[KernelConfig]:
    """SSD chunk pool: the kernel rounds a requested chunk down to the
    largest divisor of S, so only divisors are enumerated — the priced
    chunk is exactly the executed chunk."""
    divs = [d for d in range(1, s + 1) if s % d == 0]
    default = KernelConfig(chunk=max(d for d in divs
                                     if d <= min(DEFAULT_SSD_CHUNK, s)))
    pool = sorted({max(d for d in divs if d <= min(c, s))
                   for c in SSD_CHUNKS})
    out = [default] + [KernelConfig(chunk=c) for c in pool]
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


# ---------------------------------------------------------------------------
# Prepacked weight arenas
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedDense:
    """Tile-aligned dense weights: [kp, np] int8 padded to whole (bk, bn)
    tiles, neutral 1.0 scales / 0.0 biases on the padding columns."""
    w_q: torch.Tensor
    w_scale: torch.Tensor
    bias: Optional[torch.Tensor]
    k: int                         # logical dims (padded ones sliced off)
    n: int
    bk: int
    bn: int
    packed_bytes: int              # int8 weights + fp32 bias, padded


@dataclasses.dataclass
class PackedConv:
    """Channel-aligned conv weights: [KH, KW, Cin, cout_pad] int8 padded
    to whole cout_per_block blocks (0 = unpadded)."""
    w_q: torch.Tensor
    w_scale: torch.Tensor
    bias: Optional[torch.Tensor]
    cout: int
    cout_per_block: int
    packed_bytes: int


def build_packed_weights(plan, layouts: Dict[str, KernelConfig]
                         ) -> Dict[str, Any]:
    """One plan-time prepack per quantized node: alignment padding and
    neutral scale/bias extension happen HERE, once, producing device-
    resident tensors (on the plan's weights' device) that the
    ``prepacked=True`` kernel paths read in place.
    Footprints are the padded bytes (int8 weights + fp32 bias), what
    `energy.weight_bytes` and the arena budget charge."""
    packed: Dict[str, Any] = {}
    for name, qp in plan.qplans.items():
        cfg = layouts.get(name)
        if cfg is None:
            continue
        has_bias = qp.bias is not None
        if qp.op == "dense":
            k, n = (int(d) for d in qp.w_q.shape)
            kp, np_ = _ceil_to(k, cfg.bk), _ceil_to(n, cfg.bn)
            w = qp.w_q
            if (kp, np_) != (k, n):
                w = F.pad(w, (0, np_ - n, 0, kp - k))
            ws, b = pad_channel_params(qp.w_scale, qp.bias, np_ - n)
            packed[name] = PackedDense(
                w_q=w, w_scale=ws, bias=b, k=k, n=n, bk=cfg.bk, bn=cfg.bn,
                packed_bytes=kp * np_ + (np_ * 4 if has_bias else 0))
        else:
            kh, kw, cin, cout = (int(d) for d in qp.w_q.shape)
            bc = cfg.cout_per_block
            cout_pad = _ceil_to(cout, bc) if bc else cout
            w = qp.w_q
            if cout_pad != cout:
                w = F.pad(w, (0, cout_pad - cout))
            ws, b = pad_channel_params(qp.w_scale, qp.bias,
                                       cout_pad - cout)
            packed[name] = PackedConv(
                w_q=w, w_scale=ws, bias=b, cout=cout, cout_per_block=bc,
                packed_bytes=kh * kw * cin * cout_pad
                + (cout_pad * 4 if has_bias else 0))
    return packed


# ---------------------------------------------------------------------------
# The autotuner
# ---------------------------------------------------------------------------


def node_spec(plan, name: str, batch: int) -> Optional[Tuple[str, Tuple]]:
    """(kind, shape-signature) for a tunable node, or None. Signatures
    start with the batch rung — the whole (op, shape, dtype, backend,
    rung) cache identity lives here."""
    node = plan.graph.nodes[name]
    bop = base_op(node)
    # the LM kernels tune on either plan backend: unlike the hls knob,
    # (bq, bk) / chunk are bound into the executed kernel calls
    if bop == "attention":
        sq, hq, hd = node.out_shape
        sk, hkv, _ = plan.graph.nodes[node.inputs[1]].out_shape
        return "attention", (batch, int(sq), int(sk), int(hq), int(hkv),
                             int(hd),
                             1 if node.attrs.get("causal", True) else 0)
    if bop == "ssd":
        s, h, p = node.out_shape
        n = plan.graph.nodes[node.inputs[1]].out_shape[-1]
        return "ssd", (batch, int(s), int(h), int(p), int(n))
    if plan.backend == "accel" and name in plan.qplans:
        qp = plan.qplans[name]
        in_shape = plan.graph.nodes[node.inputs[0]].out_shape or ()
        if qp.op == "dense":
            if qp.per_position:
                # token-wise GEMM: M = batch x positions, K = last axis
                m = batch * int(np.prod(in_shape[:-1], dtype=np.int64))
                return "int8_dense", (m, int(in_shape[-1]),
                                      int(qp.w_q.shape[1]))
            k = int(np.prod(in_shape, dtype=np.int64))
            return "int8_dense", (batch, k, int(qp.w_q.shape[1]))
        h, w, cin = in_shape
        kh, kw, _, cout = (int(d) for d in qp.w_q.shape)
        return "int8_conv", (batch, int(h), int(w), int(cin), kh, kw,
                             cout, int(qp.stride), qp.padding)
    if plan.backend == "flex" and bop in ("conv2d", "dense"):
        in_shape = plan.graph.nodes[node.inputs[0]].out_shape or ()
        if bop == "dense":
            red = (int(in_shape[-1])
                   if node.attrs.get("per_position", False)
                   else int(np.prod(in_shape, dtype=np.int64)))
        else:
            kh, kw = node.attrs["kernel"]
            red = int(kh) * int(kw) * int(in_shape[-1])
        return "hls", (batch, int(node.ops), red)
    return None


def launch_key(kind: str, cfg: KernelConfig, device: torch.device):
    """The part of ``cfg`` that changes what the port's kernel on
    ``device`` runs. The CUDA matmul's tile is fixed at 16 x 128 x 128
    (bm/bn/bk only fix the packed layout) and the conv's row tile at 8
    (``rows_per_block`` only fixes the staging geometry), so on the card
    only the conv's ``cout_per_block`` counts; the plain CPU versions
    honour none of the settings."""
    if device.type == "cuda" and kind == "int8_conv":
        return cfg.cout_per_block
    return None


def _time_call(fn, repeats: int) -> float:
    """Best of ``repeats`` CUDA-event timings of ``fn()`` in seconds, after
    one warm-up call (which also builds a kernel on first use)."""
    fn()
    t = math.inf
    for _ in range(max(repeats, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        t = min(t, start.elapsed_time(end) * 1e-3)
    return t


class Autotuner:
    """Cost-model-guided schedule search over a plan's tunable nodes.

    One instance per engine, shared across its backends' plans: the
    ``stats`` counters are the no-research contract the tests pin —
    a warm cache performs ZERO candidate evaluations. ``device`` is where
    the opt-in measured refinement times its candidates: the card unless
    ``"cpu"`` is asked for, as for every entry point of the port (with
    ``measure=False`` nothing is timed and no device is needed)."""

    def __init__(self, cache: Optional[TuningCache] = None,
                 measure: bool = False, measure_top_k: int = 3,
                 measure_repeats: int = 2, device: DeviceLike = None):
        self.cache = cache if cache is not None else TuningCache(None)
        self.measure = measure
        self.device = (resolve_device(device)
                       if measure or device is not None else None)
        self.measure_top_k = measure_top_k
        self.measure_repeats = measure_repeats
        self.stats = {"nodes": 0, "evaluated": 0, "cache_hits": 0,
                      "measured": 0}

    # -- search --------------------------------------------------------------

    def _price(self, kind: str, sig: Tuple, hw, cfg: KernelConfig,
               resident: bool) -> Tuple[float, float, bool]:
        if kind == "int8_dense":
            m, k, n = sig
            return price_int8_dense(hw, m, k, n, cfg.bm, cfg.bn, cfg.bk,
                                    resident)
        if kind == "int8_conv":
            batch, h, w, cin, kh, kw, cout, stride, padding = sig
            return price_int8_conv(hw, batch, h, w, cin, kh, kw, cout,
                                   stride, padding,
                                   cfg.rows_per_block or DEFAULT_CONV_ROWS,
                                   cfg.cout_per_block, resident)
        if kind == "attention":
            batch, sq, sk, hq, hkv, hd, causal = sig
            return price_attention(hw, batch, sq, sk, hq, hkv, hd,
                                   bool(causal),
                                   cfg.bq or DEFAULT_ATTN_BLOCK,
                                   cfg.bk or DEFAULT_ATTN_BLOCK)
        if kind == "ssd":
            batch, s, h, p, n = sig
            return price_ssd(hw, batch, s, h, p, n,
                             cfg.chunk or DEFAULT_SSD_CHUNK)
        batch, ops, red = sig
        return price_hls(hw, batch, ops, red, cfg.unroll)

    def _candidates(self, kind: str, sig: Tuple,
                    fixed: Optional[KernelConfig]) -> List[KernelConfig]:
        if kind == "int8_dense":
            m, k, n = sig
            return dense_candidates(m, k, n, fixed)
        if kind == "int8_conv":
            _, h, w, cin, kh, kw, cout, stride, padding = sig
            h_out = conv_geometry(h, w, kh, kw, stride, padding, 1).h_out
            return conv_candidates(h_out, cout, fixed)
        if kind == "attention":
            return attention_candidates(sig[1], sig[2])
        if kind == "ssd":
            return ssd_candidates(sig[1])
        _, _, red = sig
        return hls_candidates(red)

    def _search(self, kind: str, sig: Tuple, hw, resident: bool,
                fixed: Optional[KernelConfig]) -> TuningDecision:
        cands = self._candidates(kind, sig, fixed)
        best = None
        best_score = math.inf
        priced: List[Tuple[float, float, KernelConfig]] = []

        def score(t: float, extra: float) -> float:
            # candidates are ranked on compute time PLUS the restream
            # traffic's transfer time — for non-resident-weight models a
            # small-bm config that re-streams weights per M-block must
            # not beat the one-pass default on compute time alone
            return t + extra / hw.hbm_bw

        for i, cfg in enumerate(cands):
            t, extra, feasible = self._price(kind, sig, hw, cfg, resident)
            self.stats["evaluated"] += 1
            if i == 0:
                feasible = True            # the shipped heuristic always runs
            if not feasible:
                continue
            priced.append((t, extra, cfg))
            if score(t, extra) < best_score:
                best_score = score(t, extra)
                best = (t, extra, cfg)
        t, extra, cfg = best
        # default_s is always the price of the TRUE heuristic config
        # (unconstrained): under a pinned packed layout, candidate #0 is
        # the pinned-layout default, and reporting speedups against it
        # would overstate the win
        d_default = self._candidates(kind, sig, None)[0]
        default_s = self._price(kind, sig, hw, d_default, resident)[0]
        source = "model"
        if (self.measure and kind in INT8_KINDS
                and self.measure_top_k > 0 and len(priced) > 1):
            ranked = sorted(priced, key=lambda p: score(p[0], p[1]))
            picked = self._refine_measured(kind, sig, ranked)
            if picked is not None:
                cfg = picked
                t, extra, _ = self._price(kind, sig, hw, cfg, resident)
                source = "measured"
        return TuningDecision(kind=kind, config=cfg, modeled_s=t,
                              default_s=default_s, extra_bytes=extra,
                              source=source)

    # -- measured refinement (opt-in) ----------------------------------------

    def _refine_measured(self, kind: str, sig: Tuple,
                         ranked: List[Tuple[float, float, KernelConfig]]
                         ) -> Optional[KernelConfig]:
        """Time the model's top-K distinct launches on synthetic data
        through the port's kernel wrappers and keep the fastest; None when
        the candidates do not differ in what the device runs.

        ``ranked`` is the priced candidates in the model's order. Those
        with the same :func:`launch_key` run the same kernel, so only the
        first of each is timed and, if its launch wins, the model's pick
        among them is kept. On the card that leaves the conv's
        ``cout_per_block`` (whole-Cout or channel-blocked grid, and the
        block width); the matmul's tile and the conv's row tile are fixed,
        and the plain CPU versions honour no setting, so there nothing is
        timed and the model's pick stands. A candidate the wrapper refuses
        (a whole-Cout filter over the shared-memory limit) is skipped. On
        the card each launch is timed with CUDA events after a warm-up
        call."""
        from repro_torch.kernels import ops as kops
        dev = self.device
        top: List[KernelConfig] = []
        seen = set()
        for _, _, cfg in ranked:
            key = launch_key(kind, cfg, dev)
            if key not in seen:
                seen.add(key)
                top.append(cfg)
        top = top[:self.measure_top_k]
        if len(top) < 2:
            return None
        rng = np.random.default_rng(0)

        def i8(shape):
            return torch.as_tensor(rng.integers(-127, 128, shape),
                                   dtype=torch.int8, device=dev)

        # launch_key makes only conv launches differ
        batch, h, w_, cin, kh, kw, cout, stride, padding = sig
        x, wq = i8((batch, h, w_, cin)), i8((kh, kw, cin, cout))
        ws = torch.ones((cout,), dtype=torch.float32, device=dev)
        best_cfg, best_t = None, math.inf
        for cfg in top:
            fn = lambda: kops.conv2d_int8(
                x, wq, ws, stride=stride, padding=padding,
                rows_per_block=cfg.rows_per_block or DEFAULT_CONV_ROWS,
                cout_per_block=cfg.cout_per_block)
            try:
                t = _time_call(fn, self.measure_repeats)
            except ValueError:
                continue
            self.stats["measured"] += 1
            if t < best_t:
                best_t, best_cfg = t, cfg
        return best_cfg

    # -- the plan entry point ------------------------------------------------

    def tune_plan(self, plan, batch: int,
                  layouts: Optional[Dict[str, KernelConfig]] = None
                  ) -> Dict[str, TuningDecision]:
        """Tuning decisions for every tunable node of ``plan`` at one
        batch rung. ``layouts`` pins the weight-layout dims (bn/bk or
        cout_per_block) to an existing packed arena — per-rung search
        then covers only the activation-schedule knobs."""
        hw = energy_mod.BACKEND_HW[plan.backend]
        w_bytes = energy_mod.weight_bytes(plan.graph, plan.backend,
                                          set(plan.qplans))
        resident = w_bytes <= hw.onchip_bytes
        decisions: Dict[str, TuningDecision] = {}
        for name in plan.graph.order:
            spec = node_spec(plan, name, batch)
            if spec is None:
                continue
            kind, sig = spec
            fixed = (layouts or {}).get(name)
            self.stats["nodes"] += 1
            key = cache_key(kind, sig, plan.backend, hw, fixed,
                            resident=resident,
                            measured=self.measure and kind in INT8_KINDS)
            ent = self.cache.get(key)
            if ent is not None:
                decisions[name] = TuningDecision(
                    kind=kind, config=KernelConfig.from_dict(ent["config"]),
                    modeled_s=ent["modeled_s"], default_s=ent["default_s"],
                    extra_bytes=ent.get("extra_bytes", 0.0), source="cache")
                self.stats["cache_hits"] += 1
                continue
            dec = self._search(kind, sig, hw, resident, fixed)
            self.cache.put(key, {
                "config": dec.config.to_dict(), "modeled_s": dec.modeled_s,
                "default_s": dec.default_s, "extra_bytes": dec.extra_bytes,
                "source": dec.source, "kind": kind, "sig": list(sig)})
            decisions[name] = dec
        self.cache.save()
        return decisions


def price_defaults(plan, batch: int) -> Dict[str, TuningDecision]:
    """Every tunable node priced at its heuristic DEFAULT config with the
    same kernel-level pricer — the apples-to-apples baseline the
    BENCH_autotune gates compare tuned picks against (the coarse roofline
    in `cost_signature` has no tile notion, so comparing against it would
    mix two models)."""
    hw = energy_mod.BACKEND_HW[plan.backend]
    w_bytes = energy_mod.weight_bytes(plan.graph, plan.backend,
                                      set(plan.qplans))
    resident = w_bytes <= hw.onchip_bytes
    tuner = Autotuner(TuningCache(None))
    out: Dict[str, TuningDecision] = {}
    for name in plan.graph.order:
        spec = node_spec(plan, name, batch)
        if spec is None:
            continue
        kind, sig = spec
        default = tuner._candidates(kind, sig, None)[0]
        t, extra, _ = tuner._price(kind, sig, hw, default, resident)
        out[name] = TuningDecision(kind=kind, config=default, modeled_s=t,
                                   default_s=t, extra_bytes=extra,
                                   source="default")
    return out
