"""Staged execution plans: Planned -> Lowered -> Compiled.

* :class:`ExecutionPlan` (**Planned**) — built once per (engine, backend):
  the inspector's backend assignment, the PTQ fidelity gate (nodes whose
  calibration-time quantization error is too large are demoted to the
  flex path), the graph-compiler pass pipeline (``core/passes.py``), the
  contiguous accel/flex segments over the rewritten graph, PTQ scales
  folded into per-node constants, and the static activation arena that
  prices the plan's :class:`~repro_torch.core.energy.CostSignature`.
  ``fuse=False`` skips the pass pipeline and builds per-node plans. With a
  ``tuner`` (``core/autotune.py``) the plan tunes each batch rung's kernel
  schedule at lowering and, on ``accel``, prepacks its int8 weights into
  tile-aligned arena buffers once, at ``pack_batch``.
* :class:`LoweredPlan` / :class:`CompiledPlan` — the plan bound to one
  batch size: a callable over ``[B, ...]`` tensors. PyTorch runs eagerly,
  so binding is all a lowering does; ``n_traces`` still counts lowerings
  and steady-state serving must not grow it.

Layout is NHWC at every graph value, as in the reference: library ops
that want channels first (convolution, pooling) permute inside. Every
int8 conv2d/dense runs the hand-written kernels through
:func:`_run_quantized`; the LM block's ``attention`` and ``ssd`` nodes run
the flash-attention and SSD kernels; the VAE's ``sample_normal`` the
sampler kernel. Random ops thread a per-sample key array ``rngs [B, 2]``
(raw uint32 key pairs) through the program as the reference does: each
random node splits every row's key, carries the first half on and hands
the second to the op, so row *i* of a batched run equals a single-sample
run with key ``rngs[i]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import autotune as autotune_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core import memory as memory_mod
from repro_torch.core import spans
from repro_torch.core.opgraph import (RANDOM_OPS, Graph, Node, base_op,
                                     consumers, param_node)
from repro_torch.core.passes import PassContext, PassManager, PassReport
from repro_torch.kernels import ops as kops
from repro_torch.kernels.conv2d import conv_geometry, pad_input
from repro_torch.kernels.epilogue import f32, quantize_act
from repro_torch.kernels.sample import split_keys


# ---------------------------------------------------------------------------
# Batched fp32 op implementations (leading batch dim everywhere, NHWC)
# ---------------------------------------------------------------------------


def same_pads(sizes, kernel, stride: int, padding: str) -> List[int]:
    """F.pad spec (last spatial dim first) for SAME/VALID: SAME puts the
    odd extra row/column at the end, as XLA does."""
    pads: List[int] = []
    for size, k in zip(reversed(sizes), reversed(kernel)):
        if padding == "SAME":
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        elif padding == "VALID":
            pads += [0, 0]
        else:
            raise ValueError(padding)
    return pads


def _conv_b(x, p, a, nd: int):
    w = p["w"].float()                      # HWIO / DHWIO
    k = tuple(w.shape[:nd])
    x = x.float()
    x = F.pad(x, [0, 0] + same_pads(x.shape[1:1 + nd], k,
                                    a.get("stride", 1),
                                    a.get("padding", "SAME")))
    perm_in = (0, nd + 1) + tuple(range(1, nd + 1))
    perm_w = (nd + 1, nd) + tuple(range(nd))
    conv = F.conv2d if nd == 2 else F.conv3d
    out = conv(x.permute(perm_in), w.permute(perm_w),
               stride=a.get("stride", 1), groups=a.get("groups", 1))
    perm_out = (0,) + tuple(range(2, nd + 2)) + (1,)
    return out.permute(perm_out) + p["b"]


def _pool_b(x, a, nd: int, op: str):
    k, s = a["kernel"], a.get("stride", a["kernel"])
    dtype = x.dtype
    # pooling runs in float32: exact for int8 codes (max is monotone), and
    # PyTorch's integer max-pool limits the map to the integer type's range
    xc = x.float().permute((0, nd + 1) + tuple(range(1, nd + 1)))
    if op == "max":
        pool = F.max_pool2d if nd == 2 else F.max_pool3d
        out = pool(xc, k, s)
    else:
        pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
        out = pool(xc, k, s, divisor_override=1) / (k ** nd)
    out = out.permute((0,) + tuple(range(2, nd + 2)) + (1,))
    return out.to(dtype) if op == "max" else out


def _dense_b(x, p, a):
    if a.get("per_position", False):
        out = x @ p["w"]
    else:
        out = x.reshape(x.shape[0], -1) @ p["w"]
    if "b" in p:
        out = out + p["b"]
    return out


def _reshape_b(x, a):
    tgt = list(a["shape"])
    if -1 in tgt:
        rest = int(np.prod([d for d in tgt if d != -1]))
        tgt[tgt.index(-1)] = int(np.prod(x.shape[1:])) // rest
    return x.reshape((x.shape[0],) + tuple(tgt))


def _attention_b(xs, a, config=None):
    """Batched flash attention over [B, S, H, hd] q/k/v. ``kv_int8``
    round-trips K/V through the per-(pos, head) int8 quantizer — the same
    codes the KV-cache arena stores, so prefill output equals what cached
    decode reconstructs. ``config`` carries the rung's tuned (bq, bk)."""
    q, k, v = (t.float() for t in xs)
    if a.get("kv_int8", False):
        from repro_torch.core import lm_quant
        k = lm_quant.dequantize_kv(*lm_quant.quantize_kv(k), torch.float32)
        v = lm_quant.dequantize_kv(*lm_quant.quantize_kv(v), torch.float32)
    bq = config.bq if config is not None and config.bq else a.get("bq", 256)
    bk = config.bk if config is not None and config.bk else a.get("bk", 256)
    return kops.flash_attention(q, k, v, causal=a.get("causal", True),
                                bq=bq, bk=bk)


def _ssd_b(xs, p, a, config=None):
    """The batched SSD scan: (y [B,S,H,P], final state [B,H,P,N]), both
    from one kernel call at the rung's chunk (``config`` carries the tuned
    one)."""
    x, B_, C_, dt = (t.float() for t in xs)
    chunk = (config.chunk if config is not None and config.chunk
             else a.get("chunk", 256))
    return kops.ssd(x, B_, C_, dt, p["A"], chunk=chunk)


def ssd_state_key(node: str) -> str:
    """The batched program's output name for ``ssd`` node ``node``'s final
    state (the LM commit caches it)."""
    return f"{node}/final_state"


def _concat_axis(a) -> int:
    ax = a.get("axis", -1)
    return ax + 1 if ax >= 0 else ax


BATCHED_OP_IMPLS: Dict[str, Callable] = {
    "conv2d": lambda x, p, a, rng: _conv_b(x[0], p, a, 2),
    "conv3d": lambda x, p, a, rng: _conv_b(x[0], p, a, 3),
    "maxpool2d": lambda x, p, a, rng: _pool_b(x[0], a, 2, "max"),
    "avgpool2d": lambda x, p, a, rng: _pool_b(x[0], a, 2, "avg"),
    "maxpool3d": lambda x, p, a, rng: _pool_b(x[0], a, 3, "max"),
    "avgpool3d": lambda x, p, a, rng: _pool_b(x[0], a, 3, "avg"),
    "dense": lambda x, p, a, rng: _dense_b(x[0], p, a),
    "attention": lambda x, p, a, rng: _attention_b(x, a),
    "ssd": lambda x, p, a, rng: _ssd_b(x, p, a)[0],
    "reshape": lambda x, p, a, rng: _reshape_b(x[0], a),
    "flatten": lambda x, p, a, rng: x[0].reshape(x[0].shape[0], -1),
    "relu": lambda x, p, a, rng: torch.clamp_min(x[0], 0.0),
    "leaky_relu": lambda x, p, a, rng: torch.where(
        x[0] > 0, x[0], a.get("alpha", 0.01) * x[0]),
    "sigmoid": lambda x, p, a, rng: torch.sigmoid(x[0]),
    "tanh": lambda x, p, a, rng: torch.tanh(x[0]),
    "softplus": lambda x, p, a, rng: F.softplus(x[0]),
    "exp": lambda x, p, a, rng: torch.exp(x[0]),
    "concat": lambda x, p, a, rng: torch.cat(x, dim=_concat_axis(a)),
    "add": lambda x, p, a, rng: x[0] + x[1],
    "sub": lambda x, p, a, rng: x[0] - x[1],
    "mul": lambda x, p, a, rng: x[0] * x[1],
    "greater": lambda x, p, a, rng: (x[0] > a["threshold"]).float(),
    "sample_normal": lambda x, p, a, rng: kops.sample_normal(x[0], x[1], rng),
    "argmax": lambda x, p, a, rng: torch.argmax(
        x[0].reshape(x[0].shape[0], -1), dim=1).to(torch.int32),
}


def _run_fused_f32(node: Node, xs, params) -> torch.Tensor:
    """An fp32 ``fused`` node: the base op, then its element-wise
    epilogue(s) — identical math to the unfused node pair."""
    y = BATCHED_OP_IMPLS[node.attrs["base_op"]](
        xs, params.get(param_node(node), {}), node.attrs, None)
    for e in node.attrs.get("epilogue", ()):
        y = BATCHED_OP_IMPLS[e]([y], {}, {}, None)
    return y


# ---------------------------------------------------------------------------
# Plan-time folding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous run of nodes on one backend (the paper's partial
    offload unit)."""
    backend: str                    # 'accel' | 'flex'
    nodes: Tuple[str, ...]

    @property
    def span(self) -> str:
        """Its span on a traced dispatch (``core/spans.py``):
        ``plan.accel`` or ``plan.flex``."""
        return "plan." + self.backend


@dataclasses.dataclass
class QuantNodePlan:
    """PTQ constants folded into a quantized node at plan time."""
    op: str                         # 'conv2d' | 'dense' (base compute op)
    w_q: torch.Tensor               # dense: [K, N]; conv: [KH, KW, Cin, Cout]
    w_scale: torch.Tensor           # [N] per-output-channel
    bias: Optional[torch.Tensor]
    act_scale: float                # static per-tensor input scale
    act: Optional[str] = None       # fused activation epilogue
    requant_scale: Optional[float] = None   # int8 output at this scale
    int8_input: bool = False        # producer already delivered int8
    stride: int = 1
    padding: str = "SAME"
    per_position: bool = False      # dense over the last axis only (LM)


def partition_segments(graph: Graph, assignment: Dict[str, str]
                       ) -> List[Segment]:
    """Group ``graph.order`` into contiguous same-backend runs. Inputs
    and plan-time constants are structural and never split a run."""
    segs: List[Segment] = []
    run: List[str] = []
    cur: Optional[str] = None
    for name in graph.order:
        if graph.nodes[name].op in ("input", "const"):
            continue
        b = assignment[name]
        if b != cur and run:
            segs.append(Segment(cur, tuple(run)))
            run = []
        cur = b
        run.append(name)
    if run:
        segs.append(Segment(cur, tuple(run)))
    return segs


class ExecutionPlan:
    """**Planned** stage: everything derivable without a batch size.

    :meth:`lower` binds a batch size; ``n_traces`` counts lowerings.
    ``device`` is where the plan's weights and every value it computes
    live: quantized nodes launch the CUDA kernels on a CUDA device and run
    the kernels' plain versions on the CPU. ``tuner=None`` serves the
    heuristic kernel schedule; with an :class:`~repro_torch.core.autotune.
    Autotuner` the weight layout is tuned once at ``pack_batch`` and each
    rung's schedule against that layout.
    """

    def __init__(self, graph: Graph, params: Dict[str, Dict[str, torch.Tensor]],
                 backend: str,
                 quant: Optional[Dict[str, Any]] = None,
                 act_absmax: Optional[Dict[str, float]] = None,
                 ptq_err: Optional[Dict[str, float]] = None,
                 ptq_demote_threshold: float = 0.2,
                 fuse: bool = True,
                 device: torch.device = torch.device("cpu"),
                 tuner: Optional[autotune_mod.Autotuner] = None,
                 pack_batch: int = 32):
        from repro_torch.core import inspector as inspector_mod
        missing = sorted({base_op(n) for n in graph.nodes.values()
                          if n.op not in ("input", "const")
                          and base_op(n) not in BATCHED_OP_IMPLS})
        if missing:
            raise NotImplementedError(
                f"ops not ported yet: {missing} (graph {graph.name!r})")
        self.source_graph = graph
        self.params = params
        self.backend = backend
        self.fuse = fuse
        self.device = device
        self.n_traces = 0
        # plan-time autotuning: weight-layout dims are tuned once at
        # pack_batch (weights are packed once), per-rung tuning covers only
        # the activation-schedule knobs against that fixed layout
        self.tuner = tuner
        self.pack_batch = pack_batch
        self._tuning: Dict[int, Dict[str, autotune_mod.TuningDecision]] = {}
        self._layouts: Optional[Dict[str, autotune_mod.KernelConfig]] = None
        self.packed: Dict[str, Any] = {}
        self._packed_bytes: Dict[str, int] = {}
        # live int8 weight buffers (fed to the program as ARGUMENTS) +
        # pristine host copies for re-pack recovery
        self._weight_arena: Optional[Dict[str, torch.Tensor]] = None
        self._host_weights: Dict[str, np.ndarray] = {}

        assignment = inspector_mod.assign_backends(graph)
        self.demoted: List[str] = []
        self.qplans: Dict[str, QuantNodePlan] = {}
        self.fused_into: Dict[str, str] = {}    # legacy: relu node -> producer
        self.pass_report: Optional[PassReport] = None
        self.arena: Optional[memory_mod.ArenaPlan] = None
        # static KV-cache arena (LM decode): attached after construction
        # by the LM engine through attach_kv_plan()
        self.kv_plan: Optional[memory_mod.KVCachePlan] = None

        if backend == "accel":
            if quant is None:
                raise RuntimeError(
                    "accel backend needs calibrate() first (PTQ)")
            # PTQ fidelity gate first, on the source graph
            for name in graph.order:
                node = graph.nodes[name]
                if (assignment[name] != "accel"
                        or node.op not in ("conv2d", "dense")
                        or name not in quant):
                    continue
                err = (ptq_err or {}).get(name, 0.0)
                if err > ptq_demote_threshold:
                    assignment[name] = "flex"
                    self.demoted.append(name)
        else:
            assignment = {n: "flex" for n in assignment}

        if fuse:
            ctx = PassContext(
                params=params, assignment=assignment,
                quant=quant if backend == "accel" else None,
                act_absmax=act_absmax if backend == "accel" else None)
            self.graph, self.pass_report = PassManager().run(graph, ctx)
            assignment = ctx.assignment
            if backend == "accel":
                self._fold_quant_fused(quant, act_absmax, assignment)
        else:
            self.graph = graph
            if backend == "accel":
                self._fold_quant_legacy(quant, act_absmax, assignment)

        self.assignment = assignment
        self.segments = partition_segments(self.graph, assignment)
        if fuse:
            self.arena = self._plan_arena()
        self._lowered: Dict[int, "LoweredPlan"] = {}

    # -- PTQ folding ---------------------------------------------------------

    def _act_scale(self, act_absmax: Optional[Dict[str, float]],
                   inp: str) -> float:
        from repro_torch.core.quantize import act_scale
        absmax = (act_absmax or {}).get(inp)
        if absmax is None:
            raise RuntimeError(
                f"no calibration absmax for {inp!r} (accel plan)")
        return act_scale(absmax)

    def _fold_quant_fused(self, quant, act_absmax, assignment) -> None:
        """Quantized-node constants over the pass-rewritten graph: the
        fusion decisions arrive as node attrs (epilogue / requant_scale /
        int8_input) and fold straight into the QuantNodePlan."""
        for name in self.graph.order:
            node = self.graph.nodes[name]
            bop = base_op(node)
            if (assignment.get(name) != "accel"
                    or bop not in ("conv2d", "dense")):
                continue
            pkey = param_node(node)
            if pkey not in quant:
                continue
            q = quant[pkey]
            s = self._act_scale(act_absmax, node.inputs[0])
            epi = node.attrs.get("epilogue", ())
            common = dict(
                w_scale=q.w_scale, bias=q.bias, act_scale=s,
                act=epi[0] if epi else None,
                requant_scale=node.attrs.get("requant_scale"),
                int8_input=bool(node.attrs.get("int8_input")),
                per_position=bool(node.attrs.get("per_position")))
            if bop == "conv2d":
                w4 = q.w_q.reshape(self.params[pkey]["w"].shape)
                self.qplans[name] = QuantNodePlan(
                    "conv2d", w4, stride=node.attrs.get("stride", 1),
                    padding=node.attrs.get("padding", "SAME"), **common)
            else:
                self.qplans[name] = QuantNodePlan("dense", q.w_q, **common)

    def _fold_quant_legacy(self, quant, act_absmax, assignment) -> None:
        """The pre-pass (fuse=False) folding: per-node quantization with
        sole-consumer ReLU epilogues recorded as node aliases
        (``fused_into``)."""
        cons = consumers(self.graph)
        for name in self.graph.order:
            node = self.graph.nodes[name]
            if (assignment[name] != "accel"
                    or node.op not in ("conv2d", "dense")
                    or name not in quant):
                continue
            q = quant[name]
            s = self._act_scale(act_absmax, node.inputs[0])
            fused = False
            cs = cons[name]
            if (len(cs) == 1 and self.graph.nodes[cs[0]].op == "relu"
                    and name not in self.graph.outputs
                    and assignment.get(cs[0]) == "accel"):
                fused = True
                self.fused_into[cs[0]] = name
            act = "relu" if fused else None
            if node.op == "conv2d":
                w4 = q.w_q.reshape(self.params[name]["w"].shape)
                self.qplans[name] = QuantNodePlan(
                    "conv2d", w4, q.w_scale, q.bias, s, act=act,
                    stride=node.attrs.get("stride", 1),
                    padding=node.attrs.get("padding", "SAME"))
            else:
                self.qplans[name] = QuantNodePlan(
                    "dense", q.w_q, q.w_scale, q.bias, s, act=act,
                    per_position=bool(node.attrs.get("per_position")))

    # -- arena ---------------------------------------------------------------

    def _quantized_names(self) -> set:
        return set(self.qplans)

    def _plan_arena(self) -> memory_mod.ArenaPlan:
        hw = energy_mod.BACKEND_HW[self.backend]
        w_bytes = energy_mod.weight_bytes(self.graph, self.backend,
                                          self._quantized_names(),
                                          self._packed_bytes or None)
        # BRAM-resident KV slots shrink the activation budget exactly
        # like resident weights do
        kv_bram = self.kv_plan.bram_bytes if self.kv_plan is not None else 0
        resident = w_bytes + kv_bram
        budget = max(int(hw.onchip_bytes) - resident, 0) \
            if resident <= hw.onchip_bytes else int(hw.onchip_bytes)
        act_dtype = {}
        for name, node in self.graph.nodes.items():
            if (node.attrs.get("int8")
                    or node.attrs.get("requant_scale") is not None):
                act_dtype[name] = 1     # int8-domain value
        return memory_mod.plan_arena(self.graph, self.segments, budget,
                                     act_dtype, backend=self.backend,
                                     weight_bytes=w_bytes)

    # -- autotuning -----------------------------------------------------------

    def _ensure_autotuned(self, batch_size: int) -> None:
        """Tune (and, on the accel path, prepack) once per batch rung.
        The packing step runs first, at ``pack_batch``: it fixes the
        weight-layout dims, builds the tile-aligned buffers, and
        re-budgets the activation arena against the packed footprint —
        then every rung's search is constrained to that layout."""
        if self.tuner is None or batch_size in self._tuning:
            return
        if self.backend == "accel" and self._layouts is None:
            pack = self.tuner.tune_plan(self, self.pack_batch)
            self._layouts = {
                n: d.config for n, d in pack.items()
                if d.kind in autotune_mod.INT8_KINDS}
            self.packed = autotune_mod.build_packed_weights(
                self, self._layouts)
            self._packed_bytes = {n: p.packed_bytes
                                  for n, p in self.packed.items()}
            self._weight_arena = None       # rebuild over packed buffers
            if self.arena is not None:
                self.arena = self._plan_arena()
            self._tuning[self.pack_batch] = pack
            if batch_size == self.pack_batch:
                return
        layouts = self._layouts if self.backend == "accel" else None
        self._tuning[batch_size] = self.tuner.tune_plan(
            self, batch_size, layouts=layouts)

    # -- the live weight arena -----------------------------------------------

    @property
    def weight_arena(self) -> Dict[str, torch.Tensor]:
        """Live int8 weight buffers, one per quantized node (the packed
        tile-aligned buffer where a prepacked entry exists), read by the
        program on every call (a swapped entry takes effect at once)."""
        if self._weight_arena is None:
            arena = {}
            for name, qp in self.qplans.items():
                pk = self.packed.get(name)
                arena[name] = pk.w_q if pk is not None else qp.w_q
            self._weight_arena = arena
            self._host_weights = {n: a.cpu().numpy().copy()
                                  for n, a in arena.items()}
        return self._weight_arena

    @property
    def host_weights(self) -> Dict[str, np.ndarray]:
        """Pristine host copies of the arena (the re-pack source)."""
        self.weight_arena
        return self._host_weights

    def repack_weights(self, names: Optional[List[str]] = None) -> int:
        """Restore arena entries from the pristine host copies. Returns
        the bytes rewritten."""
        arena = self.weight_arena
        total = 0
        for name in (names if names is not None else list(arena)):
            arena[name] = torch.from_numpy(
                self._host_weights[name].copy()).to(self.device)
            total += self._host_weights[name].nbytes
        return total

    # -- the batched program -------------------------------------------------

    def batched_fn(self, tuning: Optional[Dict[str, Any]] = None
                   ) -> Callable:
        """The plan as a callable ``f(inputs[B,...], rngs[B,2], weights)``:
        ``weights`` is the live :attr:`weight_arena` dict (prepacked
        entries arrive tile-aligned); ``rngs`` carries one raw key pair per
        sample for random ops (split per random node). ``tuning`` (node ->
        TuningDecision, one batch rung) binds the autotuned configs. The
        result holds the graph outputs and, under :func:`ssd_state_key`,
        each ``ssd`` node's final state. ``mark``, when given, is called
        right after the last node's launches."""
        graph, params = self.graph, self.params
        qplans, fused_into = self.qplans, self.fused_into
        packed = self.packed
        device = self.device

        def f(inputs: Dict[str, torch.Tensor], rngs: torch.Tensor,
              weights: Dict[str, torch.Tensor],
              mark: Optional[Callable[[], None]] = None
              ) -> Dict[str, torch.Tensor]:
            vals: Dict[str, torch.Tensor] = {}
            states: Dict[str, torch.Tensor] = {}    # ssd final states
            batch = rngs.shape[0]
            for name in graph.graph_inputs:
                vals[name] = inputs[name].float()
            for name in graph.order:
                node = graph.nodes[name]
                if node.op == "const":
                    v = torch.as_tensor(np.asarray(node.attrs["value"]),
                                        device=device)
                    vals[name] = v.expand((batch,) + tuple(v.shape))
            for seg in self.segments:
                with (spans.span(seg.span) if spans.on else spans.OFF):
                    for name in seg.nodes:
                        node = graph.nodes[name]
                        if name in fused_into:      # ReLU folded into producer
                            vals[name] = vals[fused_into[name]]
                            continue
                        xs = [vals[i] for i in node.inputs]
                        dec = tuning.get(name) if tuning else None
                        cfg = dec.config if dec else None
                        if name in qplans:
                            vals[name] = _run_quantized(
                                qplans[name], xs[0], config=cfg,
                                packed=packed.get(name), w_q=weights[name])
                            continue
                        if node.op == "fused":      # fp32 fused (flex path)
                            vals[name] = _run_fused_f32(node, xs, params)
                            continue
                        if node.op == "attention":
                            vals[name] = _attention_b(xs, node.attrs, cfg)
                            continue
                        if node.op == "ssd":
                            vals[name], states[ssd_state_key(name)] = _ssd_b(
                                xs, params.get(name, {}), node.attrs, cfg)
                            continue
                        sub = None
                        if node.op in RANDOM_OPS:
                            rngs, sub = split_keys(rngs)
                        vals[name] = BATCHED_OP_IMPLS[node.op](
                            xs, params.get(name, {}), node.attrs, sub)
            if mark is not None:
                mark()
            return {**{o: vals[o] for o in graph.outputs}, **states}

        return f

    # -- staging -------------------------------------------------------------

    def lower(self, batch_size: int) -> "LoweredPlan":
        if batch_size in self._lowered:
            return self._lowered[batch_size]
        self._ensure_autotuned(batch_size)
        self.weight_arena
        self.n_traces += 1
        lp = LoweredPlan(self, batch_size,
                         self.batched_fn(self._tuning.get(batch_size)))
        self._lowered[batch_size] = lp
        return lp

    def cost_signature(self, batch_size: int,
                       backend: Optional[str] = None
                       ) -> energy_mod.CostSignature:
        """Plan-time modeled cost of one ``batch_size`` dispatch on this
        plan's backend (``backend`` overrides for the cpu/EagerPlan view).
        Fused plans price DDR traffic from the static arena; the eager
        cpu view and unfused plans keep the op-by-op bytes model. A tuned
        plan prices its nodes with the kernel-level pricer of its rung's
        decisions and charges the packed weight footprint."""
        if backend is None and self.tuner is not None:
            self._ensure_autotuned(batch_size)
            return self._charge_kv(self.tuned_cost_signature(
                batch_size, self._tuning[batch_size],
                packed_bytes=self._packed_bytes or None))
        if self.arena is not None and backend is None:
            return self._charge_kv(energy_mod.plan_cost_signature(
                self.graph, self.backend, batch_size, self.arena,
                quantized=self._quantized_names()))
        return self._charge_kv(energy_mod.cost_signature(
            self.graph, backend or self.backend, batch_size,
            quantized=self._quantized_names()))

    def attach_kv_plan(self, kv_plan: memory_mod.KVCachePlan) -> None:
        """Charge a static KV-cache arena to this plan: BRAM-resident
        slots shrink the activation-arena budget exactly like resident
        weights, and every cost signature reports the packed KV footprint
        (``kv_resident_bytes``)."""
        self.kv_plan = kv_plan
        if self.arena is not None:
            self.arena = self._plan_arena()

    def _charge_kv(self, sig: energy_mod.CostSignature
                   ) -> energy_mod.CostSignature:
        if self.kv_plan is None:
            return sig
        return dataclasses.replace(
            sig, kv_resident_bytes=float(self.kv_plan.total_bytes))

    def stage_costs(self, batch_size: int,
                    backend: Optional[str] = None
                    ) -> Tuple[energy_mod.StageCost, ...]:
        """The plan's pipeline-stage decomposition at ``batch_size``:
        host stage_in -> one stage per segment -> host readback. The
        ``backend`` override (the EagerPlan cpu view) is one monolithic
        eager stage."""
        if backend is not None and backend != self.backend:
            sig = self.cost_signature(batch_size, backend=backend)
            return (energy_mod.StageCost("eager", backend, sig.latency_s),)
        node_times = None
        if self.tuner is not None:
            self._ensure_autotuned(batch_size)
            node_times = {n: d.modeled_s
                          for n, d in self._tuning[batch_size].items()}
        return energy_mod.stage_costs(
            self.graph, self.backend, batch_size, self.segments,
            arena=self.arena, quantized=self._quantized_names(),
            node_times=node_times,
            packed_bytes=self._packed_bytes or None)

    def pipelined_cost_signature(self, batch_size: int,
                                 backend: Optional[str] = None
                                 ) -> energy_mod.CostSignature:
        """`cost_signature` with the pipelined-latency term: the longest
        stage of `stage_costs`."""
        sig = self.cost_signature(batch_size, backend=backend)
        stages = self.stage_costs(batch_size, backend=backend)
        return dataclasses.replace(
            sig, pipelined_latency_s=max(s.seconds for s in stages))

    def default_cost_signature(self, batch_size: int
                               ) -> energy_mod.CostSignature:
        """The heuristic-default configs priced through the same
        kernel-level pricer (and the same packed footprint) as the tuned
        signature: the baseline of every default-vs-tuned comparison."""
        return self.tuned_cost_signature(
            batch_size, autotune_mod.price_defaults(self, batch_size),
            packed_bytes=self._packed_bytes or None)

    def tuned_cost_signature(self, batch_size: int,
                             decisions: Dict[str, Any],
                             packed_bytes: Optional[Dict[str, int]] = None
                             ) -> energy_mod.CostSignature:
        """The plan's cost signature with the kernel-level pricing of a
        decision set substituted for the coarse per-node roofline term."""
        node_times = {n: d.modeled_s for n, d in decisions.items()}
        extra = sum(d.extra_bytes for d in decisions.values())
        if self.arena is not None:
            return energy_mod.plan_cost_signature(
                self.graph, self.backend, batch_size, self.arena,
                quantized=self._quantized_names(), node_times=node_times,
                extra_bytes=extra, packed_bytes=packed_bytes)
        return energy_mod.cost_signature(
            self.graph, self.backend, batch_size,
            quantized=self._quantized_names(), node_times=node_times,
            extra_bytes=extra, packed_bytes=packed_bytes)

    # -- reporting -----------------------------------------------------------

    def summary(self) -> str:
        n_fused = sum(1 for n in self.graph.nodes.values()
                      if n.op == "fused")
        lines = [f"ExecutionPlan[{self.graph.name}/{self.backend}]: "
                 f"{len(self.segments)} segment(s), "
                 f"{len(self.qplans)} quantized node(s), "
                 f"{n_fused + len(self.fused_into)} fused epilogue(s), "
                 f"fuse={'on' if self.fuse else 'off'}"]
        for seg in self.segments:
            lines.append(f"  [{seg.backend:5s}] {seg.nodes[0]} .. "
                         f"{seg.nodes[-1]} ({len(seg.nodes)} nodes)")
        if self.pass_report is not None and self.pass_report.n_rewrites:
            lines.append("  passes:")
            lines.append(self.pass_report.summary())
        if self.demoted:
            lines.append(f"  PTQ-demoted to flex: {self.demoted}")
        if self.arena is not None:
            a = self.arena
            lines.append(
                f"  arena: peak {a.bram_peak:,}/{a.bram_budget:,} B BRAM, "
                f"{a.n_spilled} spill(s), "
                f"{a.ddr_bytes_per_sample:,} DDR B/sample")
        if self.kv_plan is not None:
            lines.append("  " + self.kv_plan.summary())
        return "\n".join(lines)

    def as_text(self) -> str:
        """Full textual plan dump: the rewritten graph, per-node
        quantization state, fusion groups, the autotuner's decisions, and
        the arena table."""
        lines = [self.summary(), "", self.graph.summary()]
        if self.qplans:
            lines.append("")
            for name, qp in self.qplans.items():
                bits = [f"s_in={qp.act_scale:.3g}"]
                if qp.act:
                    bits.append(f"act={qp.act}")
                if qp.requant_scale is not None:
                    bits.append(f"requant={qp.requant_scale:.3g}")
                if qp.int8_input:
                    bits.append("int8-in")
                lines.append(f"  int8 {name:24s} {qp.op:7s} "
                             + " ".join(bits))
        if self._tuning:
            lines.append("")
            lines.extend(self.autotune_lines())
        if self.arena is not None:
            lines.append("")
            lines.append(self.arena.summary())
        return "\n".join(lines)

    def autotune_lines(self) -> List[str]:
        """One block per tuned batch rung: each node's decision, its
        modeled time against the default's, and its packed footprint."""
        lines = []
        for bsz in sorted(self._tuning):
            lines.append(f"  autotune @ batch {bsz}:")
            for name, d in self._tuning[bsz].items():
                cfg = d.config
                if d.kind == "int8_dense":
                    desc = f"tile {cfg.bm}x{cfg.bn}x{cfg.bk}"
                elif d.kind == "int8_conv":
                    desc = f"rows/blk {cfg.rows_per_block}"
                    if cfg.cout_per_block:
                        desc += f" cout/blk {cfg.cout_per_block}"
                elif d.kind == "attention":
                    desc = f"blocks bq={cfg.bq} bk={cfg.bk}"
                elif d.kind == "ssd":
                    desc = f"chunk {cfg.chunk}"
                else:
                    desc = f"unroll x{cfg.unroll}"
                pk = self.packed.get(name)
                pb = (f"  packed={pk.packed_bytes:,} B"
                      if pk is not None else "")
                lines.append(
                    f"    {name:24s} {desc:20s} "
                    f"t={d.modeled_s*1e6:9.2f} us "
                    f"(default {d.default_s*1e6:9.2f} us, "
                    f"x{d.speedup:.2f}) [{d.source}]{pb}")
        return lines


def _run_quantized(qp: QuantNodePlan, x: torch.Tensor,
                   config: Optional[Any] = None,
                   packed: Optional[Any] = None,
                   w_q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One kernel per quantized layer: static-scale quantize -> int8
    matmul/conv -> dequant (+bias, +act, +requantize) epilogue.

    Activations beyond the calibration absmax saturate at +-127, as on the
    accelerator. When the producer already requantized (``int8_input``)
    the incoming int8 values are consumed directly. With ``packed`` (a
    prepacked arena entry) the kernels read the tile-aligned weights in
    place, and the conv's input is staged once by the plan-time geometry;
    ``config`` binds the rung's tuned schedule. Both paths are bit-exact
    to the heuristic one. ``w_q`` is the node's live weight-arena buffer
    (``packed.w_q`` / ``qp.w_q`` when omitted)."""
    s = qp.act_scale
    wq = w_q if w_q is not None else (
        packed.w_q if packed is not None else qp.w_q)
    if qp.op == "dense":
        # per_position folds every leading (batch, position) axis into
        # the matmul M dim and restores them afterwards
        lead = x.shape[:-1] if qp.per_position else (x.shape[0],)
        x2 = (x.reshape(-1, x.shape[-1]) if qp.per_position
              else x.reshape(x.shape[0], -1))
        x_q = x2 if qp.int8_input else quantize_act(x2, s)
        scales = torch.full((x2.shape[0],), f32(s), dtype=torch.float32,
                            device=x2.device)
        if packed is not None:
            out = kops.int8_matmul(
                x_q, wq, scales, packed.w_scale, packed.bias, act=qp.act,
                requant_scale=qp.requant_scale,
                bm=(config.bm if config and config.bm else 128),
                bn=packed.bn, bk=packed.bk, prepacked=True, n_out=packed.n)
        else:
            out = kops.int8_matmul(x_q, wq, scales, qp.w_scale, qp.bias,
                                   act=qp.act,
                                   requant_scale=qp.requant_scale)
        if qp.per_position:
            out = out.reshape(tuple(lead) + (out.shape[-1],))
        return out
    x_q = x if qp.int8_input else quantize_act(x, s)
    if packed is not None:
        h, w = int(x_q.shape[1]), int(x_q.shape[2])
        kh, kw = int(wq.shape[0]), int(wq.shape[1])
        rows = (config.rows_per_block
                if config and config.rows_per_block else 8)
        geom = conv_geometry(h, w, kh, kw, qp.stride, qp.padding, rows)
        x_q = pad_input(x_q, geom)       # plan-time geometry, one pad op
        return kops.conv2d_int8(
            x_q, wq, packed.w_scale, packed.bias, x_scale=s,
            stride=qp.stride, padding=qp.padding, act=qp.act,
            requant_scale=qp.requant_scale, rows_per_block=rows,
            cout_per_block=packed.cout_per_block, cout=packed.cout,
            pre_padded=True, in_hw=(h, w))
    return kops.conv2d_int8(
        x_q, wq, qp.w_scale, qp.bias, x_scale=s,
        stride=qp.stride, padding=qp.padding, act=qp.act,
        requant_scale=qp.requant_scale)


class LoweredPlan:
    """**Lowered** stage: the program bound to one batch size."""

    def __init__(self, plan: ExecutionPlan, batch_size: int, fn: Callable):
        self.plan = plan
        self.batch_size = batch_size
        self.fn = fn
        self._compiled: Optional[CompiledPlan] = None

    def compile(self) -> "CompiledPlan":
        if self._compiled is None:
            self._compiled = CompiledPlan(self.plan, self.batch_size, self.fn)
        return self._compiled


class CompiledPlan:
    """**Compiled** stage: calling it runs the plan at its batch size and
    never lowers again. Carries its plan-time cost signature (modeled
    FLOPs / bytes / J-per-inference / W of one dispatch) and its stage
    decomposition, which the scheduler ranks and prices dispatches with."""

    def __init__(self, plan: ExecutionPlan, batch_size: int, fn: Callable):
        self.plan = plan
        self.batch_size = batch_size
        self._fn = fn
        self.cost = plan.pipelined_cost_signature(batch_size)
        self.stages = plan.stage_costs(batch_size)

    @property
    def n_traces(self) -> int:
        return self.plan.n_traces

    def __call__(self, inputs: Dict[str, torch.Tensor], rngs: torch.Tensor,
                 mark: Optional[Callable[[], None]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Run the plan; ``mark`` is called right after its last launch."""
        with torch.no_grad():
            return self._fn(inputs, rngs, self.plan.weight_arena, mark)


class EagerPlan(CompiledPlan):
    """The cpu-backend stage: the flex plan, priced as the paper's ARM-CPU
    '1x' eager baseline (PyTorch runs every plan eagerly, so only the
    cost model differs from :class:`CompiledPlan`)."""

    def __init__(self, plan: ExecutionPlan, batch_size: int):
        self.plan = plan
        self.batch_size = batch_size
        self._fn = plan.batched_fn()
        self.cost = plan.pipelined_cost_signature(batch_size, backend="cpu")
        self.stages = plan.stage_costs(batch_size, backend="cpu")
