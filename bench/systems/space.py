"""The space networks served by ``repro_torch``: an ``Engine`` built from
the program's graph (``models.SPACE_MODELS``) with weights drawn from the
seed, calibrated by post-training quantization, and registered with a
pipelined ``ContinuousBatchingScheduler``, which the benchmark drives
through ``start()``, ``submit()`` and ``stop()`` as a deployment drives it.
The benchmark wraps the scheduler's ticket retirement to time each answer
on the host and, in the closed loop, to submit the next frame.

``correct`` holds the answers against the plain reference. Every request
the run submitted must have an answer. A sample of the answered requests,
drawn from the seed, always with the ragged tail of a closed loop in it,
is recomputed by the configuration's reference (``reference/<config>.py``)
from inputs it makes again from the seed: the same weights and frames,
calibration redone on the same calibration frames, and for a random
output the request's own key. For each output the number compared is the
widest gap between the program's answer and the reference's, over the
sample, as a share of the reference's largest magnitude in that output.
The limits are the configuration's (``check.limits`` in its file).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import check, devtrace, harness
from bench.reference import common

# the scheduler's ``step`` issues every device operation; the pipeline's
# stages are the spans a traced run names the device's idle gaps by
STEP_LABEL = "sched.step"
PIPELINE_SPANS = (("_stage", "pipeline.stage"),
                  ("_dispatch", "plan.dispatch"),
                  ("_unstage", "pipeline.unstage"),
                  ("_keep", "pipeline.keep"))


# ---------------------------------------------------------------------------
# Inputs and weights from the seed
# ---------------------------------------------------------------------------


def make_params(shapes, seed: int, device, bias_std: float):
    """Every parameter the configuration names, from one draw on the
    device: He-normal conv weights (HWIO, DHWIO), LeCun-normal dense
    weights ([in, out]), biases normal at ``bias_std``."""
    sizes = [(node, part, tuple(shape)) for node, sh in shapes.items()
             for part, shape in sh.items()]
    total = sum(math.prod(s) for _, _, s in sizes)
    flat = torch.randn(total, generator=harness.generator(seed, device),
                       device=device)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    off = 0
    for node, part, shape in sizes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if part == "w":
            gain = 2.0 if len(shape) in (4, 5) else 1.0
            v = v * math.sqrt(gain / math.prod(shape[:-1]))
        else:
            v = v * bias_std
        params.setdefault(node, {})[part] = v
    return params


@dataclasses.dataclass
class Inputs:
    """What one seed makes, on ``device`` and as host arrays."""
    params: Dict[str, Dict[str, torch.Tensor]]
    calib: Dict[str, torch.Tensor]
    pool: Dict[str, torch.Tensor]

    def host(self):
        return ({k: v.cpu().numpy() for k, v in self.calib.items()},
                {k: v.cpu().numpy() for k, v in self.pool.items()})


def make_inputs(cfg, ref, seed: int, device) -> Inputs:
    s_par, s_cal, s_pool = harness.stream_seeds(seed, 3)
    params = make_params(ref.param_shapes(cfg), s_par, device,
                         cfg["bias_std"])
    calib = ref.frames(harness.generator(s_cal, device),
                       cfg["calibration_frames"], cfg, device)
    pool = ref.frames(harness.generator(s_pool, device), cfg["pool_frames"],
                      cfg, device)
    return Inputs(params, calib, pool)


def check_shapes(graph, shapes) -> None:
    """The program's graph must name exactly the reference's parameters:
    conv weights HWIO or DHWIO, dense weights [in, out]."""
    got = {}
    for name in graph.order:
        node = graph.nodes[name]
        if node.op in ("conv2d", "conv3d", "dense"):
            cout = node.attrs["features"]
            if node.op == "dense":
                fin = int(np.prod(graph.nodes[node.inputs[0]].out_shape))
                got[name] = {"w": (fin, cout), "b": (cout,)}
            else:
                kernel = tuple(node.attrs["kernel"])
                cin = graph.nodes[node.inputs[0]].out_shape[-1]
                got[name] = {"w": kernel + (cin, cout), "b": (cout,)}
    want = {n: {k: tuple(v) for k, v in s.items()} for n, s in shapes.items()}
    if got != want:
        raise ValueError(f"the program's layers {got} are not the "
                         f"configuration's {want}")


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


class System:
    """The served model: an ``Engine`` calibrated on the configuration's
    calibration frames and registered with a pipelined
    ``ContinuousBatchingScheduler`` as ``launch/serve.build_scheduler``
    registers it (keep predicate, warm-up sample, the launcher's default
    of pipelined dispatch over 2 staging buffers)."""

    def __init__(self, cfg, ref, ladder, seed: int, device):
        from repro_torch.core.engine import Engine
        from repro_torch.core.scheduler import ContinuousBatchingScheduler
        from repro_torch.launch.serve import KEEP_PREDICATES
        from repro_torch.models import SPACE_MODELS

        self.cfg, self.model, self.device = cfg, cfg["model"], device
        inputs = make_inputs(cfg, ref, seed, device)
        calib, self.pool = inputs.host()
        self.n_pool = cfg["pool_frames"]
        graph = SPACE_MODELS[self.model].build_graph(**cfg["build_args"])
        check_shapes(graph, ref.param_shapes(cfg))
        self.engine = Engine(graph, inputs.params, device=device,
                             ptq_demote_threshold=cfg["ptq_demote_threshold"])
        calib_reqs = [{k: v[i] for k, v in calib.items()}
                      for i in range(cfg["calibration_frames"])]
        self.engine.calibrate(calib_reqs)
        self.sched = ContinuousBatchingScheduler(pipeline=True,
                                                 staging_buffers=2)
        self.sched.register(self.model, self.engine,
                            backend=(cfg["backend"],), ladder=tuple(ladder),
                            deadline_s=cfg["deadline_s"],
                            keep_predicate=KEEP_PREDICATES.get(self.model),
                            warmup_sample=calib_reqs[0])
        self.deadline_s = cfg["deadline_s"]
        self.reqs: Dict[int, harness.Req] = {}
        self.on_answers: Optional[Callable[[int, float], None]] = None
        # a request's record exists before its retirement can look for it
        self._lock = threading.Lock()
        self._wrap_retire()

    def _wrap_retire(self) -> None:
        orig = self.sched._retire

        def retire(inf):
            orig(inf)
            t = time.monotonic()
            with self._lock:
                for row, r in enumerate(inf.reqs):
                    q = self.reqs[r.rid]
                    q.answered, q.dispatched = t, inf.started
                    q.rec_idx, q.row, q.rung = inf.rec_idx, row, inf.rung
            cb = self.on_answers
            if cb is not None:
                cb(len(inf.reqs), t)

        self.sched._retire = retire

    def frame(self, k: int) -> Dict[str, np.ndarray]:
        """A fresh request dict over pool frame ``k mod pool``."""
        i = k % self.n_pool
        return {name: v[i] for name, v in self.pool.items()}

    def submit(self, k: int, due: float, tail: bool = False) -> harness.Req:
        with self._lock:
            rid = self.sched.submit(self.model, self.frame(k), arrival=due)
            req = harness.Req(rid, k % self.n_pool, due, time.monotonic(),
                              tail=tail)
            self.reqs[rid] = req
        return req

    def start(self) -> None:
        self.sched.start()

    def stop(self) -> None:
        self.sched.stop(drain=True)

    def outputs(self) -> Dict[int, Dict[str, np.ndarray]]:
        return {c.rid: c.outputs for c in self.sched.completions}

    def release(self) -> None:
        self.sched = self.engine = None

    def trace_hooks(self) -> devtrace.Hooks:
        """The scheduler's ``step`` on its dispatcher thread, and the four
        stages of every pipeline the scheduler registered."""
        sched = self.sched
        spans = [(pipe, attr, label)
                 for svc in sched._svcs.values()
                 for rungs in svc.pipelines.values()
                 for pipe in rungs.values()
                 for attr, label in PIPELINE_SPANS]
        return devtrace.Hooks(
            step=(sched, "step"), step_label=STEP_LABEL,
            on_thread=lambda: threading.current_thread() is sched._thread,
            spans=spans, dispatches=lambda: sched.dispatches)


def build(cfg, ref, traffic, seed: int, device) -> System:
    return System(cfg, ref, traffic["ladder"], seed, device)


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def reference_outputs(cfg, ref, seed: int, device, picked, bits: int = 8,
                      demoted: Optional[set] = None
                      ) -> Tuple[Dict[str, np.ndarray], set]:
    """The reference's answers to ``picked``, and the layers it kept in
    fp32. Inputs are made again from the seed, on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        inputs = make_inputs(cfg, ref, seed, device)
        qs = common.calibrate(ref.forward, inputs.params, inputs.calib, bits,
                              cfg["ptq_demote_threshold"], demoted)
        keys = None
        if "sample" in ref.OUTPUTS:
            chain = common.ServedKeys(cfg["model"])
            keys = np.stack([chain.layer_key(r.rec_idx, r.rung, r.row)
                             for r in picked])
        idx = torch.tensor([r.frame for r in picked], device=device)
        outs: Dict[str, List[np.ndarray]] = {k: [] for k in ref.OUTPUTS}
        for s in range(0, len(picked), check.BLOCK):
            sl = idx[s:s + check.BLOCK]
            batch = {k: v[sl] for k, v in inputs.pool.items()}
            got = ref.forward(inputs.params, batch, qs.serving,
                              None if keys is None
                              else keys[s:s + check.BLOCK])
            for k in ref.OUTPUTS:
                outs[k].append(got[k].float().cpu().numpy())
        del inputs
    return {k: np.concatenate(v) for k, v in outs.items()}, qs.demoted


def compare(cfg, ref, seed: int, device, reqs, outputs
            ) -> Tuple[Dict[str, list], set]:
    """``{name: [value, limit]}`` for every number compared (the run is
    correct when no value passes its limit), and the layers the
    reference's demotion gate kept in fp32."""
    missing = sum(1 for r in reqs if r.rid not in outputs)
    picked = check.sample(reqs, cfg["check"]["sample"], seed)
    numbers: Dict[str, list] = {"answers_missing": [missing, 0]}
    if not picked:
        raise RuntimeError("no answered request to check")
    want, demoted = reference_outputs(cfg, ref, seed, device, picked)
    for name in ref.OUTPUTS:
        got = np.stack([np.asarray(outputs[r.rid][name]).reshape(-1)
                        for r in picked])
        numbers[f"{name}_gap"] = [
            check.gap(got, want[name].reshape(len(picked), -1)),
            cfg["check"]["limits"][name]]
    return numbers, demoted


def control(cfg, ref, seed: int, device, picked) -> Dict[str, float]:
    """The control: the reference in int4, the precision below the
    configuration's, in the program's place, read against the int8
    reference by the same gaps (the int8 run's fp32 layers stay fp32)."""
    want, demoted = reference_outputs(cfg, ref, seed, device, picked)
    got, _ = reference_outputs(cfg, ref, seed, device, picked, bits=4,
                               demoted=demoted)
    return {f"{k}_gap": check.gap(got[k], want[k]) for k in ref.OUTPUTS}
