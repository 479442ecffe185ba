"""Static activation-buffer planner — the BRAM/DDR two-tier arena
(DESIGN.md §10).

The paper's HLS designs owe their energy win to *buffer planning*: each
layer's output streams into an on-chip buffer sized at synthesis time,
and DDR is touched only at the design's boundary. This module does the
same planning for an execution plan, at plan time:

* **liveness** — every non-input node's value is live from its
  definition to its last use (graph outputs stay live to the end: they
  are the downlink payload).
* **arena assignment** — buffers are packed into a single BRAM arena
  (first-fit over live intervals, the classic static allocator) whose
  budget is the backend's on-chip memory minus resident weights. What
  does not fit *spills* to DDR.
* **tier rules** — a value consumed outside its producing segment
  crosses a backend boundary and must round-trip DDR regardless of
  size; graph inputs arrive from DDR; graph outputs leave to DDR.

The resulting :class:`ArenaPlan` is what `energy.plan_cost_signature`
charges: DDR bytes for spills and boundaries only — on-chip traffic is
free, which is precisely why operator fusion (fewer, narrower
intermediates: int8 instead of fp32) measurably lowers the modeled
J/inference.

Buffers are sized per *sample*: the accelerator streams one sample's
intermediates at a time (batch amortizes staging, not buffer size).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.opgraph import Graph


@dataclasses.dataclass(frozen=True)
class BufferAssignment:
    name: str                       # producing node
    nbytes: int                     # per-sample bytes
    tier: str                       # 'bram' | 'ddr'
    offset: int                     # arena offset (bram) or -1 (ddr)
    first: int                      # def position in topo order
    last: int                       # last-use position
    reason: str = ""                # 'spill' | 'boundary' | '' (bram)


@dataclasses.dataclass
class ArenaPlan:
    """The static buffer plan for one execution plan (one backend)."""
    graph_name: str
    backend: str
    bram_budget: int                # bytes available to activations
    buffers: Dict[str, BufferAssignment]
    bram_peak: int                  # high-water mark of the arena
    input_bytes: int                # graph inputs read from DDR, /sample
    output_bytes: int               # graph outputs written to DDR, /sample
    spill_bytes: int                # DDR round-trip traffic from spills
    boundary_bytes: int             # DDR round-trips at segment crossings
    weight_bytes: int = 0           # resident weight footprint the budget
                                    # was derived from — the PACKED
                                    # (tile-padded) bytes when a prepacked
                                    # weight arena exists (DESIGN.md §11)

    @property
    def n_spilled(self) -> int:
        return sum(1 for b in self.buffers.values()
                   if b.tier == "ddr" and b.reason == "spill")

    @property
    def ddr_bytes_per_sample(self) -> int:
        """Modeled DDR traffic one sample causes through activations."""
        return (self.input_bytes + self.output_bytes
                + self.spill_bytes + self.boundary_bytes)

    def summary(self) -> str:
        lines = [f"arena[{self.graph_name}/{self.backend}]: "
                 f"peak {self.bram_peak:,} / {self.bram_budget:,} B BRAM, "
                 f"{self.n_spilled} spill(s), "
                 f"{self.ddr_bytes_per_sample:,} DDR B/sample"
                 + (f", {self.weight_bytes:,} B resident weights"
                    if self.weight_bytes else "")]
        for b in self.buffers.values():
            where = (f"bram@{b.offset}" if b.tier == "bram"
                     else f"ddr({b.reason})")
            lines.append(f"    {b.name:24s} {b.nbytes:10,d} B  "
                         f"[{b.first:3d},{b.last:3d}]  {where}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class StagingPlan:
    """The HOST-side staging arena for one (plan, batch rung): the fixed
    fp32 batch-buffer shape of every graph input and the slot count the
    double-buffered pipeline preallocates (DESIGN.md §12).

    Planned statically, like the device arena above: the serving loop
    reuses these buffers for every dispatch (batch k+1 is assembled in a
    free slot while batch k computes) instead of allocating a fresh host
    stack per `jax.device_put`. A slot is owned by its in-flight dispatch
    until the dispatch's ticket retires — `jax.device_put` may alias host
    memory, so an owned slot is never rewritten."""
    graph_name: str
    batch_size: int
    slots: int
    input_shapes: Dict[str, Tuple[int, ...]]    # name -> [B, ...] shape

    @property
    def input_bytes(self) -> Dict[str, int]:
        """fp32 bytes of each input buffer, per slot."""
        return {k: int(np.prod(s, dtype=np.int64)) * 4
                for k, s in self.input_shapes.items()}

    @property
    def slot_bytes(self) -> int:
        return sum(self.input_bytes.values())

    @property
    def total_bytes(self) -> int:
        return self.slot_bytes * self.slots

    def summary(self) -> str:
        return (f"staging[{self.graph_name}/b{self.batch_size}]: "
                f"{self.slots} slot(s) x {self.slot_bytes:,} B "
                f"({self.total_bytes:,} B host arena)")


def plan_staging(graph: Graph, batch_size: int, slots: int = 2
                 ) -> StagingPlan:
    """Size the host staging arena for ``batch_size`` dispatches of
    ``graph``: one fp32 ``[batch_size, ...]`` buffer per graph input per
    slot. ``slots=2`` is classic double buffering; more slots deepen the
    in-flight window the async scheduler may keep open."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if slots < 1:
        raise ValueError(f"staging needs >= 1 slot, got {slots}")
    shapes = {name: (batch_size,) + tuple(shape)
              for name, shape in graph.graph_inputs.items()}
    return StagingPlan(graph_name=graph.name, batch_size=batch_size,
                       slots=slots, input_shapes=shapes)


def _nbytes(graph: Graph, name: str,
            act_dtype_bytes: Dict[str, int]) -> int:
    shape = graph.nodes[name].out_shape or ()
    return int(np.prod(shape, dtype=np.int64)) * act_dtype_bytes.get(name, 4)


def plan_arena(graph: Graph,
               segments: Sequence,          # plan.Segment sequence
               bram_budget: int,
               act_dtype_bytes: Optional[Dict[str, int]] = None,
               backend: str = "flex",
               weight_bytes: int = 0) -> ArenaPlan:
    """Assign every activation a tier (+ BRAM offset) via liveness-aware
    first-fit. ``act_dtype_bytes`` maps node name -> bytes/element (1 for
    int8-domain values, default 4); ``bram_budget`` is the on-chip bytes
    left after resident weights — ``weight_bytes`` records the footprint
    that budget was derived from (the packed/padded bytes when a
    prepacked weight arena exists), for reporting."""
    from repro_torch.core.opgraph import consumers as _consumers

    act_dtype_bytes = act_dtype_bytes or {}
    cons = _consumers(graph)
    seg_of: Dict[str, int] = {}
    for si, seg in enumerate(segments):
        for n in seg.nodes:
            seg_of[n] = si

    pos = {name: i for i, name in enumerate(graph.order)}
    end = len(graph.order)
    last_use: Dict[str, int] = {
        name: max([pos[c] for c in cs] or [pos[name]])
        for name, cs in cons.items() if name in pos}
    for o in graph.outputs:
        last_use[o] = end                       # downlink payload

    buffers: Dict[str, BufferAssignment] = {}
    live: List[Tuple[int, int, int]] = []       # (offset, nbytes, last)
    bram_peak = 0
    spill_bytes = boundary_bytes = 0

    def _first_fit(nbytes: int) -> Optional[int]:
        taken = sorted((o, o + s) for o, s, _ in live)
        cursor = 0
        for lo, hi in taken:
            if lo - cursor >= nbytes:
                break
            cursor = max(cursor, hi)
        if cursor + nbytes > bram_budget:
            return None
        return cursor

    for name in graph.order:
        node = graph.nodes[name]
        if node.op in ("input", "const"):
            continue
        t = pos[name]
        # expire buffers whose last use is strictly past (a node may not
        # overwrite a value still being read at t)
        live[:] = [e for e in live if e[2] >= t]
        nbytes = _nbytes(graph, name, act_dtype_bytes)
        last = last_use.get(name, t)
        # write always; read back only if somebody actually reads it (a
        # consumer-less output is written once for downlink, never read)
        traffic = nbytes * (2 if cons.get(name) else 1)
        crosses = any(seg_of.get(c) != seg_of.get(name)
                      for c in cons.get(name, ()))
        if crosses:
            # a backend boundary forces a DDR round-trip regardless of size
            buffers[name] = BufferAssignment(name, nbytes, "ddr", -1, t,
                                             last, "boundary")
            boundary_bytes += traffic
            continue
        off = _first_fit(nbytes)
        if off is None:
            buffers[name] = BufferAssignment(name, nbytes, "ddr", -1, t,
                                             last, "spill")
            spill_bytes += traffic
            continue
        live.append((off, nbytes, last))
        bram_peak = max(bram_peak, off + nbytes)
        buffers[name] = BufferAssignment(name, nbytes, "bram", off, t, last)

    input_bytes = sum(_nbytes(graph, n, act_dtype_bytes)
                      for n in graph.graph_inputs)
    # DDR-tier outputs already paid their write in spill/boundary traffic
    output_bytes = sum(
        _nbytes(graph, o, act_dtype_bytes) for o in set(graph.outputs)
        if o in buffers and buffers[o].tier == "bram")
    return ArenaPlan(
        graph_name=graph.name,
        backend=backend,
        bram_budget=bram_budget,
        buffers=buffers,
        bram_peak=bram_peak,
        input_bytes=input_bytes,
        output_bytes=output_bytes,
        spill_bytes=spill_bytes,
        boundary_bytes=boundary_bytes,
        weight_bytes=weight_bytes,
    )


# ---------------------------------------------------------------------------
# Per-request KV-cache slots (LM autoregressive decode — DESIGN.md §15)
# ---------------------------------------------------------------------------

# slot capacities are padded to a whole number of 128-position tiles: the
# int8 K/V planes then tile cleanly on the MXU lane dim, and every slot
# in the arena shares one static shape (no per-request re-trace)
KV_TILE = 128


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Per-slot cache geometry for ONE stateful LM node."""
    node: str                       # graph node the cache backs
    kind: str                       # 'attention' | 'ssd'
    shape: Tuple[int, ...]          # attention: [capacity, Hkv, hd]
                                    # ssd:       [H, P, N]
    slot_bytes: int                 # one request's bytes for this node

    def describe(self) -> str:
        return (f"{self.node}[{self.kind}] {self.shape} "
                f"{self.slot_bytes:,} B/slot")


@dataclasses.dataclass
class KVCachePlan:
    """The static KV-cache arena: ``n_slots`` fixed-capacity per-request
    slots, sized at plan time and charged to the memory budget like
    prepacked weights. Attention nodes store int8 K/V codes plus f16
    per-(position, head) scale planes; SSD nodes store their fp32
    recurrent state. Steady-state decode reuses these buffers in place —
    zero allocations, zero re-traces."""
    graph_name: str
    n_slots: int
    capacity: int                   # tile-aligned max sequence length
    specs: Dict[str, KVSpec]
    tier: str                       # 'bram' | 'ddr'

    @property
    def slot_bytes(self) -> int:
        return sum(s.slot_bytes for s in self.specs.values())

    @property
    def total_bytes(self) -> int:
        return self.slot_bytes * self.n_slots

    @property
    def bram_bytes(self) -> int:
        return self.total_bytes if self.tier == "bram" else 0

    @property
    def ddr_bytes(self) -> int:
        return self.total_bytes if self.tier == "ddr" else 0

    def summary(self) -> str:
        return (f"kv[{self.graph_name}]: {self.n_slots} slot(s) x "
                f"{self.slot_bytes:,} B (cap {self.capacity}) = "
                f"{self.total_bytes:,} B {self.tier}")


def plan_kv_cache(graph: Graph, n_slots: int, max_seq: int,
                  bram_available: int = 0) -> KVCachePlan:
    """Size the per-request KV-cache slots for every stateful node of an
    LM graph. ``max_seq`` (prompt + generated tokens) is padded up to a
    whole number of :data:`KV_TILE` positions; the arena lands in BRAM
    when all slots fit in ``bram_available`` (on-chip bytes left after
    resident weights), otherwise DDR — mirroring the weight-residency
    policy."""
    from repro_torch.core.opgraph import base_op as _base_op

    if n_slots < 1:
        raise ValueError(f"KV cache needs >= 1 slot, got {n_slots}")
    if max_seq < 1:
        raise ValueError(f"max_seq must be >= 1, got {max_seq}")
    capacity = -(-max_seq // KV_TILE) * KV_TILE
    specs: Dict[str, KVSpec] = {}
    for name in graph.order:
        node = graph.nodes[name]
        bop = _base_op(node)
        if bop == "attention":
            _, hkv, hd = graph.nodes[node.inputs[1]].out_shape
            # int8 K + V codes, f16 K + V scale planes
            nbytes = 2 * capacity * hkv * hd + 2 * capacity * hkv * 2
            specs[name] = KVSpec(name, "attention",
                                 (capacity, hkv, hd), nbytes)
        elif bop == "ssd":
            _, h, p = graph.nodes[node.inputs[0]].out_shape
            n = graph.nodes[node.inputs[1]].out_shape[-1]
            specs[name] = KVSpec(name, "ssd", (h, p, n), h * p * n * 4)
    total = sum(s.slot_bytes for s in specs.values()) * n_slots
    tier = "bram" if total and total <= bram_available else "ddr"
    return KVCachePlan(graph_name=graph.name, n_slots=n_slots,
                       capacity=capacity, specs=specs, tier=tier)


class KVSlotAllocator:
    """Free-list allocator over the KV arena's request slots, driven by
    the scheduler at request admission/retirement. Counts every assign —
    the steady-state-decode gate asserts the count does NOT move while
    tokens stream (all allocation happened at admission)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        self._owner: Dict[object, int] = {}
        self.n_assigns = 0
        self.high_water = 0

    @property
    def in_use(self) -> int:
        return self.n_slots - len(self._free)

    def assign(self, request_id) -> Optional[int]:
        """Claim a slot for ``request_id``; None when the arena is full
        (the scheduler keeps the request queued)."""
        if request_id in self._owner:
            raise ValueError(f"request {request_id!r} already holds "
                             f"slot {self._owner[request_id]}")
        if not self._free:
            return None
        slot = self._free.pop(0)
        self._owner[request_id] = slot
        self.n_assigns += 1
        self.high_water = max(self.high_water, self.in_use)
        return slot

    def release(self, request_id) -> int:
        slot = self._owner.pop(request_id)
        self._free.append(slot)
        return slot

    def slot_of(self, request_id) -> int:
        return self._owner[request_id]


# ---------------------------------------------------------------------------
# Protection domains: ECC/TMR footprint + MBU interleaving (DESIGN.md §16)
# ---------------------------------------------------------------------------


def protected_weight_bytes(packed_bytes: int, mode: str) -> int:
    """Packed-weight arena footprint under a protection mode: SEC-DED
    ECC adds 8 check bits per 64 data bits (+12.5%); spatial TMR keeps
    three live copies (x3). This is the footprint the protected cost
    signature charges against the BRAM budget."""
    if packed_bytes < 0:
        raise ValueError(f"packed_bytes must be >= 0, got {packed_bytes}")
    if mode == "none":
        return packed_bytes
    if mode == "ecc":
        return (packed_bytes * 9 + 7) // 8      # ceil(x * 9/8)
    if mode == "tmr":
        return packed_bytes * 3
    raise ValueError(f"unknown protection mode {mode!r}; expected "
                     f"'none' | 'ecc' | 'tmr'")


@dataclasses.dataclass(frozen=True)
class ProtectionDomainPlan:
    """How the arena's bytes map onto independent ECC domains.

    An adjacent multi-bit burst (MBU) flips one bit in each of ``span``
    consecutive bytes. SEC-per-domain ECC corrects at most ONE corrupted
    byte per domain word, so the layout decides correctability:

    * **interleaved** (the planner's choice): byte i belongs to domain
      i mod n_domains, so a burst of span <= n_domains lands at most one
      byte in any domain — correctable by construction.
    * **contiguous** (the naive layout): domains are consecutive
      stripes; a burst lands entirely inside one stripe and puts all
      ``span`` bytes into one domain word — detect-only for span > 1.
    """
    total_bytes: int
    n_domains: int
    interleaved: bool = True

    def __post_init__(self):
        if self.total_bytes < 0:
            raise ValueError("total_bytes must be >= 0")
        if self.n_domains < 1:
            raise ValueError("n_domains must be >= 1")

    def domain_of(self, byte: int) -> int:
        if not (0 <= byte < max(self.total_bytes, 1)):
            raise ValueError(f"byte {byte} outside arena "
                             f"[0, {self.total_bytes})")
        if self.interleaved:
            return byte % self.n_domains
        stripe = max(1, -(-self.total_bytes // self.n_domains))
        return min(byte // stripe, self.n_domains - 1)

    def domains_hit(self, offset: int, span: int) -> Dict[int, int]:
        """domain -> corrupted-byte count for a burst at ``offset``."""
        hits: Dict[int, int] = {}
        for b in range(offset, min(offset + span, self.total_bytes)):
            d = self.domain_of(b)
            hits[d] = hits.get(d, 0) + 1
        return hits

    def worst_hit(self, span: int) -> int:
        """Max bytes any single domain absorbs from ANY span-byte burst."""
        span = max(0, min(span, self.total_bytes))
        if span == 0:
            return 0
        if self.interleaved:
            return -(-span // self.n_domains)        # ceil
        stripe = max(1, -(-self.total_bytes // self.n_domains))
        return min(span, stripe)

    def correctable(self, span: int) -> bool:
        """Can SEC-per-domain ECC correct EVERY possible placement of a
        span-byte adjacent burst? (<= 1 corrupted byte per domain.)"""
        return 0 < span and self.worst_hit(span) <= 1


def plan_protection_domains(total_bytes: int, n_domains: int = 4,
                            interleaved: bool = True) -> ProtectionDomainPlan:
    """Plan the arena's ECC-domain layout. The default is interleaved —
    the whole point of the layout pass: one MBU burst of span up to
    ``n_domains`` can only put a single byte in any one domain, keeping
    it SEC-correctable where the contiguous layout would only detect."""
    return ProtectionDomainPlan(total_bytes=total_bytes,
                                n_domains=max(1, n_domains),
                                interleaved=interleaved)
