"""Dual-backend inference engine — plan once, serve batches.

Three execution backends for an op graph:

* ``cpu``   — the ARM-CPU baseline analog: the flex program, priced as
              the paper's eager '1x' baseline.
* ``flex``  — the Vitis-HLS analog: fp32 math, every operator.
* ``accel`` — the Vitis-AI/DPU analog: INT8 PTQ weights and the
              hand-written int8 kernels for conv2d and dense with fused
              dequant/act/requant epilogues, on a restricted operator set
              (core/inspector.py); unsupported or PTQ-demoted nodes fall
              back to the flex path (partial offload).

``device`` says where the engine's tensors live and its programs run: the
card by default (raising when there is none), or ``"cpu"``, where every
kernel is replaced by its plain PyTorch version. The backend is a plan
choice, the device an execution choice; the two are independent.

``autotune=True`` runs the plan-time tile search and weight prepack
(``core/autotune.py``) at lowering; ``autotune=False`` (the default) serves
the heuristic kernel schedule. Both give bit-identical int8 outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import inspector as inspector_mod
from repro_torch.core.opgraph import Graph
from repro_torch.core.plan import BATCHED_OP_IMPLS, EagerPlan, ExecutionPlan
from repro_torch.core.quantize import QuantizedLayer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.sample import split

# ---------------------------------------------------------------------------
# Single-sample fp32 op implementations (calibration tracing, constant
# folding) — derived from the batched table so calibration-time math can
# never drift from the math the plans serve.
# ---------------------------------------------------------------------------


def _single_sample(op_impl: Callable) -> Callable:
    def f(xs, p, a, rng):
        if not any(isinstance(x, torch.Tensor) for x in xs):
            # plan-time constant folding hands numpy values: fold on the
            # CPU so the caller can read the result back with np.asarray
            xs = [torch.as_tensor(np.asarray(x)) for x in xs]
            p = {k: v.cpu() for k, v in p.items()}
        sub = None if rng is None else torch.as_tensor(rng).reshape(1, 2)
        return op_impl([x[None] for x in xs], p, a, sub)[0]
    return f


OP_IMPLS: Dict[str, Callable] = {
    op: _single_sample(impl) for op, impl in BATCHED_OP_IMPLS.items()}


@dataclasses.dataclass
class EnginePlan:
    graph: Graph
    assignment: Dict[str, str]          # node -> 'accel' | 'flex'
    coverage: float                     # fraction of MACs on the accel path


class Engine:
    """Executes an op graph on a chosen backend (or a partitioned mix)."""

    def __init__(self, graph: Graph, params: Dict[str, Dict[str, object]],
                 ptq_demote_threshold: float = 0.2, fuse: bool = True,
                 device: DeviceLike = None, autotune: bool = False,
                 tuning_cache=None, autotune_measure: bool = False,
                 autotune_pack_batch: int = 32):
        self.device = resolve_device(device)
        self.graph = graph
        self.params = {
            node: {k: (v if isinstance(v, torch.Tensor)
                       else torch.as_tensor(np.asarray(v))).to(self.device)
                   for k, v in p.items()}
            for node, p in params.items()}
        self.ptq_demote_threshold = ptq_demote_threshold
        # fuse=False skips the graph-compiler pass pipeline
        self.fuse = fuse
        # autotune=True tunes kernel schedules and prepacks weights at
        # lowering. ``tuning_cache`` is a JSON path (or a TuningCache):
        # a warm cache skips every candidate evaluation;
        # ``autotune_measure`` also times the model's top-K picks that
        # launch different kernels on the card
        self.autotune = autotune
        self.autotune_pack_batch = autotune_pack_batch
        self._tuner = None
        if autotune:
            from repro_torch.core.autotune import Autotuner, TuningCache
            cache = (tuning_cache if isinstance(tuning_cache, TuningCache)
                     else TuningCache(tuning_cache))
            self._tuner = Autotuner(cache, measure=autotune_measure,
                                    device=self.device)
        elif tuning_cache is not None or autotune_measure:
            # silently dropping these would serve heuristic plans while
            # the caller believes a warm cache is in play
            raise ValueError(
                "tuning_cache/autotune_measure require autotune=True")
        self._quant: Optional[Dict[str, QuantizedLayer]] = None
        self._calib: Dict[str, float] = {}
        self._ptq_err: Dict[str, float] = {}
        self._planned: Dict[str, ExecutionPlan] = {}
        self._compiled: Dict[tuple, object] = {}

    @property
    def tuner(self):
        """The engine's Autotuner (None when ``autotune=False``): its
        ``stats`` and ``cache`` show whether a lowering searched."""
        return self._tuner

    # -- planning (paper: run the inspector, then choose the toolchain) -----

    def plan(self) -> EnginePlan:
        assignment = inspector_mod.assign_backends(self.graph)
        macs = self.graph.n_macs or 1
        accel_macs = sum(n.macs for n in self.graph.nodes.values()
                         if assignment[n.name] == "accel")
        return EnginePlan(self.graph, assignment, accel_macs / macs)

    # -- PTQ ----------------------------------------------------------------

    def calibrate(self, sample_inputs: List[Dict[str, np.ndarray]]) -> None:
        """Post-training quantization: record per-node activation absmax
        over a calibration set, quantize weights per-output-channel, and
        measure per-node PTQ error (the plan-time demotion gate)."""
        from repro_torch.core.quantize import (_trace, calibrate_graph,
                                               ptq_error_ratios,
                                               quantize_weights)
        with torch.no_grad():
            traces = [_trace(self, s) for s in sample_inputs]
            self._calib = calibrate_graph(self, sample_inputs, traces=traces)
            self._quant = quantize_weights(self.graph, self.params)
            self._ptq_err = ptq_error_ratios(self, sample_inputs, self._quant,
                                             self._calib, traces=traces)
        self._invalidate_accel()

    def share_calibration(self, other: "Engine") -> None:
        """Adopt ``other``'s PTQ calibration state (same graph and params):
        activation absmax, quantized weights (moved to this engine's
        device), and the per-node PTQ error map."""
        self._quant = (None if other._quant is None else
                       {n: q.to(self.device) for n, q in other._quant.items()})
        self._calib = dict(other._calib)
        self._ptq_err = dict(other._ptq_err)
        self._invalidate_accel()

    def load_calibration(self, calib) -> None:
        """Adopt calibration state carried from elsewhere (a
        :class:`~repro_torch.convert.Calibration`: absmax and PTQ error
        maps) and quantize this engine's own weights."""
        from repro_torch.core.quantize import quantize_weights
        self._calib = dict(calib.act_absmax)
        self._ptq_err = dict(calib.ptq_err)
        with torch.no_grad():
            self._quant = quantize_weights(self.graph, self.params)
        self._invalidate_accel()

    def _invalidate_accel(self) -> None:
        # new scales/weights invalidate any previously folded accel plan
        self._planned.pop("accel", None)
        self._compiled = {k: v for k, v in self._compiled.items()
                          if k[0] != "accel"}

    # -- staged compilation --------------------------------------------------

    def planned(self, backend: str = "flex") -> ExecutionPlan:
        """The **Planned** stage for a backend (cached per instance)."""
        key = "accel" if backend == "accel" else "flex"
        if key not in self._planned:
            self._planned[key] = ExecutionPlan(
                self.graph, self.params, key,
                quant=self._quant, act_absmax=self._calib,
                ptq_err=self._ptq_err,
                ptq_demote_threshold=self.ptq_demote_threshold,
                fuse=self.fuse, device=self.device, tuner=self._tuner,
                pack_batch=self.autotune_pack_batch)
        return self._planned[key]

    def compile(self, backend: str = "flex", batch_size: int = 1):
        """The **Compiled** stage: one batched program per (backend,
        batch-size), cached."""
        if backend not in ("cpu", "flex", "accel"):
            raise ValueError(backend)
        key = (backend, batch_size)
        if key not in self._compiled:
            planned = self.planned(backend)
            if backend == "cpu":
                self._compiled[key] = EagerPlan(planned, batch_size)
            else:
                self._compiled[key] = planned.lower(batch_size).compile()
        return self._compiled[key]

    # -- execution ----------------------------------------------------------

    def run(self, inputs: Dict[str, np.ndarray], backend: str = "flex",
            rng: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """Single-sample execution — a batch-1 view over the compiled plan."""
        batched = self.run_batch(
            {k: np.asarray(v, np.float32)[None] for k, v in inputs.items()},
            backend,
            rngs=None if rng is None else np.asarray(rng)[None])
        return {k: v[0] for k, v in batched.items()}

    def run_batch(self, inputs: Dict[str, object], backend: str = "flex",
                  rngs: Optional[np.ndarray] = None
                  ) -> Dict[str, torch.Tensor]:
        """Batched execution: every input carries a leading batch dim;
        ``rngs`` is one raw key pair per sample ([B, 2] uint32 values; by
        default the reference's, the split of key (0, 0) into B keys)."""
        staged = {}
        batch = None
        for name, shape in self.graph.graph_inputs.items():
            v = inputs[name]
            x = (v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v, np.float32)))
            x = x.to(self.device, torch.float32)
            if batch is None:
                batch = x.shape[0]
            if tuple(x.shape) != (batch,) + tuple(shape):
                raise ValueError(f"input {name!r}: shape {tuple(x.shape)}, "
                                 f"want ({batch}, *{shape})")
            staged[name] = x
        if rngs is None:
            rngs = split(np.zeros(2, np.uint32), batch)
        rngs = torch.as_tensor(np.asarray(rngs, np.int64))
        if tuple(rngs.shape) != (batch, 2):
            raise ValueError(f"rngs: shape {tuple(rngs.shape)}, want "
                             f"({batch}, 2)")
        return self.compile(backend, batch)(staged, rngs)
