"""LM serving engine — autoregressive decode over the compiled op graph.

``LMEngine`` wraps an :class:`~repro_torch.core.engine.Engine` holding a
decoder-block graph (``models/lm.py``) and makes decode a statically
planned workload, as the reference's engine (src/repro/core/lm.py):

* **Prefill** runs THE compiled plan, one program per batch rung: the
  ``attn`` node launches the flash-attention kernel, the ``ssm`` node the
  SSD kernel, every quantized projection the int8 matmul. The graph
  exposes its KV/state capture points as outputs (``k_heads`` /
  ``v_heads`` / ``ssm_heads`` / ``b_proj`` / ``dt``); the per-rung
  *commit* quantizes K/V (``lm_quant.quantize_kv``: int8 codes + f16
  per-token-head scale planes) into the request's KV slot, and writes
  the SSD kernel's final state (which the plan returns beside its
  outputs, ``plan.ssd_state_key``) into the slot's state buffer. The
  reference recomputes that state with a per-position ``lax.scan``; the
  chunked kernel's state agrees with it to the SSD tolerance (1e-4).

* **Decode** is a per-rung single-token program over the SAME rewritten
  plan (same ``QuantNodePlan`` constants, same fused nodes, same live
  weight arena), with the ``attention`` node replaced by a masked attend
  over the dequantized int8 cache and the ``ssd`` node by the one-step SSD
  recurrence on the cached state. Both stay plain PyTorch, as the
  reference keeps them plain ``jnp``: a decode step is a memory-bound GEMV
  over a dynamic prefix length, with nothing to tile.

* **KV slots** come from the static planner
  (:func:`~repro_torch.core.memory.plan_kv_cache`): fixed-capacity,
  tile-aligned int8 K/V arenas charged to the plan's budget and its
  :class:`~repro_torch.core.energy.CostSignature`. Slot assign/release is
  the only per-request state transition: once each rung's programs exist,
  steady-state decode builds nothing and allocates no slot
  (``n_traces`` / ``KVSlotAllocator.n_assigns`` are the counters).

Unlike the reference, whose arenas are immutable values replaced on every
step, the port updates the cache arenas IN PLACE (indexed assignment on
the device tensors): a step writes only the positions it appends. Padding
lanes of a partly filled rung all point at the scratch row (index
``n_slots``); duplicate indices there race harmlessly, because that row
is never read back for a real lane.

The K/V cache is int8 always: on quantized plans the pass pipeline's
``kv_int8`` annotation makes prefill attention round-trip its K/V through
the same quantizer, so prefill math matches what decode reads back;
unquantized (flex) plans stream fp32 K/V in prefill and pay a one-time
int8 rounding at the cache boundary.

Prompts are full fixed-length windows (``graph_inputs['x'][0]``
positions): the SSD prefill state is the scan's final state, which is
only the request's state when the prompt fills the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import energy as energy_mod
from repro_torch.core import lm_quant
from repro_torch.core import memory as memory_mod
from repro_torch.core.engine import Engine
from repro_torch.core.opgraph import RANDOM_OPS, base_op
from repro_torch.core.plan import (BATCHED_OP_IMPLS, _run_fused_f32,
                                   _run_quantized, ssd_state_key)
from repro_torch.kernels.epilogue import f32

NEG_INF = -2.0e38                      # matches kernels/flash_attention.py


@dataclasses.dataclass(frozen=True)
class StepResult:
    """One prefill/decode dispatch's outputs, already on the host."""
    tokens: np.ndarray                  # [B] int32 argmax tokens
    hidden: np.ndarray                  # [B, D] next-step input features


class LMEngine:
    """Scheduler-facing serving facade over one decoder-block engine."""

    def __init__(self, engine: Engine, backend: str = "accel",
                 n_slots: int = 4, max_new_tokens: int = 32,
                 logits_node: str = "head", hidden_node: str = "resid2"):
        if not engine.fuse:
            raise ValueError(
                "LMEngine requires fuse=True (the kv_int8 annotation and "
                "epilogue/requant fusion live in the pass pipeline)")
        self.engine = engine
        self.device = engine.device
        self.backend = backend
        self.logits_node = logits_node
        self.hidden_node = hidden_node
        self.plan = engine.planned(backend)
        graph = self.plan.graph
        bad = [n for n in graph.order if graph.nodes[n].op in RANDOM_OPS]
        if bad:
            raise ValueError(f"LM decode cannot replay RANDOM_OPS: {bad}")
        for out in (logits_node, hidden_node):
            if out not in graph.outputs:
                raise ValueError(f"{out!r} must be a graph output")
        self.seq_len = int(graph.graph_inputs["x"][0])
        self.d_model = int(graph.graph_inputs["x"][1])
        self.max_new_tokens = int(max_new_tokens)
        self.n_slots = int(n_slots)

        # capture-point bookkeeping: every attention k/v input must be a
        # graph output (prefill visibility); the ssd state comes from the
        # kernel
        self._attn_nodes = [n for n in graph.order
                            if base_op(graph.nodes[n]) == "attention"]
        self._ssd_nodes = [n for n in graph.order
                           if base_op(graph.nodes[n]) == "ssd"]
        missing = []
        for n in self._attn_nodes:
            missing += [i for i in graph.nodes[n].inputs[1:3]
                        if i not in graph.outputs]
        if missing:
            raise ValueError(
                f"KV capture inputs must be graph outputs: {missing}")

        # the static KV arena: charged to the plan's budget + signature
        hw = energy_mod.BACKEND_HW[backend]
        self.kv_plan = memory_mod.plan_kv_cache(
            graph, n_slots, self.seq_len + self.max_new_tokens,
            bram_available=hw.onchip_bytes)
        self.plan.attach_kv_plan(self.kv_plan)
        self.capacity = self.kv_plan.capacity
        self.slots = memory_mod.KVSlotAllocator(n_slots)

        # slot arenas: n_slots real rows + one scratch row (index
        # n_slots) that padding lanes in a partially-filled rung target
        self.caches: Dict[str, object] = self._init_caches()
        # (phase, rung) programs built so far; each first use is a counted
        # trace, as the reference's per-rung jit builds are
        self._built: Set[Tuple[str, int]] = set()
        self.lm_traces = 0

    # -- cache arenas --------------------------------------------------------

    def _init_caches(self) -> Dict[str, object]:
        rows, cap, dev = self.n_slots + 1, self.capacity, self.device
        caches: Dict[str, object] = {
            "pos": torch.zeros((rows,), dtype=torch.int64, device=dev)}
        graph = self.plan.graph
        for n in self._attn_nodes:
            _, hkv, hd = graph.nodes[graph.nodes[n].inputs[1]].out_shape
            caches[n] = {
                "k_codes": torch.zeros((rows, cap, hkv, hd),
                                       dtype=torch.int8, device=dev),
                "k_scale": torch.ones((rows, cap, hkv),
                                      dtype=torch.float16, device=dev),
                "v_codes": torch.zeros((rows, cap, hkv, hd),
                                       dtype=torch.int8, device=dev),
                "v_scale": torch.ones((rows, cap, hkv),
                                      dtype=torch.float16, device=dev)}
        for n in self._ssd_nodes:
            node = graph.nodes[n]
            _, h, p = graph.nodes[node.inputs[0]].out_shape
            nstate = graph.nodes[node.inputs[1]].out_shape[-1]
            caches[n] = {"state": torch.zeros(
                (rows, h, p, nstate), dtype=torch.float32, device=dev)}
        return caches

    @property
    def scratch_slot(self) -> int:
        """The slot id padding lanes write to (never read back)."""
        return self.n_slots

    @property
    def n_traces(self) -> int:
        """Total build count: plan lowerings + LM commit/decode builds.
        Steady-state serving must not grow it."""
        return self.plan.n_traces + self.lm_traces

    # -- slot lifecycle (driven by the scheduler) ----------------------------

    def assign_slot(self, request_id) -> Optional[int]:
        return self.slots.assign(request_id)

    def release_slot(self, request_id) -> int:
        return self.slots.release(request_id)

    def _build(self, phase: str, rung: int) -> None:
        if (phase, rung) not in self._built:
            self._built.add((phase, rung))
            self.lm_traces += 1

    def _slot_tensor(self, slot_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slot_ids, np.int64),
                               device=self.device)

    # -- prefill -------------------------------------------------------------

    def prefill(self, x: np.ndarray, slot_ids: np.ndarray) -> StepResult:
        """Run one prefill rung: ``x`` [B, S, D] prompt windows,
        ``slot_ids`` [B] KV slots (``scratch_slot`` for padding lanes).
        Commits quantized K/V + SSD state into the slots and returns each
        lane's first generated token + feedback features."""
        outs = self.engine.run_batch({"x": x}, self.backend)
        self._build("commit", int(x.shape[0]))
        with torch.no_grad():
            self._commit(outs, self._slot_tensor(slot_ids), self.caches)
            tokens = torch.argmax(outs[self.logits_node][:, -1], dim=-1)
            hidden = outs[self.hidden_node][:, -1]
        return StepResult(tokens=tokens.to(torch.int32).cpu().numpy(),
                          hidden=hidden.cpu().numpy())

    def _commit(self, outs, slot_ids: torch.Tensor, caches) -> None:
        graph = self.plan.graph
        s = self.seq_len
        for n in self._attn_nodes:
            node = graph.nodes[n]
            for which, src in (("k", node.inputs[1]), ("v", node.inputs[2])):
                codes, scale = lm_quant.quantize_kv(outs[src])
                c, sc = caches[n][f"{which}_codes"], caches[n][f"{which}_scale"]
                c[slot_ids, :s] = codes
                c[slot_ids, s:] = 0
                sc[slot_ids, :s] = scale.to(torch.float16)
                sc[slot_ids, s:] = 1.0
        for n in self._ssd_nodes:
            caches[n]["state"][slot_ids] = outs[ssd_state_key(n)]
        caches["pos"][slot_ids] = s

    # -- decode --------------------------------------------------------------

    def decode_step(self, hidden: np.ndarray, slot_ids: np.ndarray
                    ) -> StepResult:
        """One decode rung: ``hidden`` [R, D] feedback features,
        ``slot_ids`` [R] slots (``scratch_slot`` for padding lanes).
        Appends each lane's new K/V at its position counter and returns
        the next token + feedback features. Nothing is built once the
        rung is warm; no slot is ever allocated here."""
        self._build("decode", int(hidden.shape[0]))
        x = torch.tensor(np.asarray(hidden, np.float32), device=self.device)
        with torch.no_grad():
            tok, hid = self._decode(x, self._slot_tensor(slot_ids),
                                    self.caches, self.plan.weight_arena)
        return StepResult(tokens=tok.cpu().numpy(), hidden=hid.cpu().numpy())

    def _decode(self, x, slot_ids, caches, weights):
        """The single-token program over the plan's rewritten graph."""
        plan = self.plan
        graph, params = plan.graph, plan.params
        vals: Dict[str, torch.Tensor] = {"x": x.float()}
        pos = caches["pos"][slot_ids]                   # [R] tokens cached
        pos_w = torch.clamp_max(pos, self.capacity - 1)  # clamped write index
        for name in graph.order:
            node = graph.nodes[name]
            if node.op == "input":
                continue
            if node.op == "const":
                v = torch.as_tensor(np.asarray(node.attrs["value"]),
                                    device=x.device)
                vals[name] = v.expand((x.shape[0],) + tuple(v.shape))
                continue
            if name in plan.fused_into:
                vals[name] = vals[plan.fused_into[name]]
                continue
            xs = [vals[i] for i in node.inputs]
            if name in plan.qplans:
                vals[name] = _run_quantized(plan.qplans[name], xs[0],
                                            packed=plan.packed.get(name),
                                            w_q=weights[name])
                continue
            if node.op == "fused" and base_op(node) != "attention":
                vals[name] = _run_fused_f32(node, xs, params)
                continue
            if node.op == "reshape":
                # per-sample [S, ...] targets lose the position axis at
                # decode: one token, same trailing dims
                vals[name] = xs[0].reshape(
                    (xs[0].shape[0],) + tuple(node.out_shape[1:]))
                continue
            if base_op(node) == "attention":
                vals[name] = _decode_attend(xs, slot_ids, pos, pos_w,
                                            caches[name])
                continue
            if base_op(node) == "ssd":
                cache = caches[name]["state"]
                y, state = _decode_ssd(xs, params[name]["A"],
                                       cache[slot_ids])
                cache[slot_ids] = state
                vals[name] = y
                continue
            vals[name] = BATCHED_OP_IMPLS[node.op](
                xs, params.get(name, {}), node.attrs, None)
        caches["pos"].index_put_((slot_ids,), torch.ones_like(slot_ids),
                                 accumulate=True)
        tok = torch.argmax(vals[self.logits_node], dim=-1)
        return tok.to(torch.int32), vals[self.hidden_node]


def _ssd_step(state, xt, bt, dtt, a) -> torch.Tensor:
    """One position of the SSD recurrence: ``state`` [R,H,P,N], ``xt``
    [R,H,P], ``bt`` [R,N], ``dtt`` [R,H], ``a`` [H]."""
    decay = torch.exp(dtt * a)
    return (state * decay[..., None, None]
            + (dtt[..., None] * xt)[..., None] * bt[:, None, None, :])


def _decode_attend(xs, slot_ids, pos, pos_w, cache) -> torch.Tensor:
    """Single-token attend over the int8 slot cache: write the new K/V at
    ``pos_w`` (in place), then masked-softmax over positions ``<= pos``."""
    q, k_new, v_new = (t.float() for t in xs)
    kc, ks = lm_quant.quantize_kv(k_new)            # [R,Hkv,hd] / [R,Hkv]
    vc, vs = lm_quant.quantize_kv(v_new)
    cache["k_codes"][slot_ids, pos_w] = kc
    cache["k_scale"][slot_ids, pos_w] = ks.to(torch.float16)
    cache["v_codes"][slot_ids, pos_w] = vc
    cache["v_scale"][slot_ids, pos_w] = vs.to(torch.float16)
    k_all = lm_quant.dequantize_kv(cache["k_codes"][slot_ids],
                                   cache["k_scale"][slot_ids], torch.float32)
    v_all = lm_quant.dequantize_kv(cache["v_codes"][slot_ids],
                                   cache["v_scale"][slot_ids], torch.float32)
    cap, hq, hd = k_all.shape[1], q.shape[1], q.shape[2]
    group = hq // k_all.shape[2]                    # GQA repeat factor
    k_r = k_all.repeat_interleave(group, dim=2)     # [R,cap,Hq,hd]
    v_r = v_all.repeat_interleave(group, dim=2)
    scores = torch.einsum("rhd,rchd->rhc", q, k_r) * f32(hd ** -0.5)
    live = (torch.arange(cap, device=q.device)[None, :] <= pos[:, None])
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("rhc,rchd->rhd", probs, v_r)


def _decode_ssd(xs, a, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSD recurrence step on the cached state: ``xs`` = (x [R,H,P],
    B [R,N], C [R,N], dt [R,H])."""
    xh, b_, c_, dt = (t.float() for t in xs)
    state = _ssd_step(state, xh, b_, dt, a)
    return torch.einsum("rn,rhpn->rhp", c_, state), state
