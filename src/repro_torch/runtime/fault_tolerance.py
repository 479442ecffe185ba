"""Fault tolerance & straggler mitigation for 1000+-node runs.

On a real multi-pod deployment the coordinator runs these policies; here
the mechanisms are implemented host-side (pure numpy/python, unit-tested)
and wired into the launcher:

* :class:`HeartbeatTable` — per-host liveness with configurable timeout;
  a missed deadline marks the host dead and triggers elastic re-mesh.
* :func:`detect_stragglers` — median-rule step-time outlier detection
  (the spot-checkable version of TPU runtime preemption signals).
* :func:`elastic_mesh_shape` — given surviving host count, the largest
  (pod, data, model) mesh reachable without resharding the model axis
  (TP degree is fixed by weight layout; we shed data-parallel rows).
* :class:`StepGuard` — wraps the train step with checkpoint-on-failure +
  resume bookkeeping; used by launch/train.py and the restart test.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------


class HeartbeatTable:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[str, float] = {h: now for h in hosts}
        self._dead: set = set()

    def beat(self, host: str) -> None:
        if host not in self._dead:
            self._last[host] = self._clock()

    def dead_hosts(self) -> List[str]:
        now = self._clock()
        for h, t in self._last.items():
            if h not in self._dead and now - t > self.timeout_s:
                self._dead.add(h)
        return sorted(self._dead)

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self._last if h not in dead)


# ---------------------------------------------------------------------------
# Stragglers
# ---------------------------------------------------------------------------


def detect_stragglers(step_times: Dict[str, float],
                      tolerance: float = 2.0) -> List[str]:
    """Hosts whose step time exceeds ``tolerance`` x median."""
    if len(step_times) < 3:
        return []
    med = float(np.median(list(step_times.values())))
    return sorted(h for h, t in step_times.items() if t > tolerance * med)


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------


def elastic_mesh_shape(alive_chips: int, model_degree: int,
                       pod_size: int = 256) -> Tuple[int, int, int]:
    """Largest (pods, data, model) using <= alive_chips, keeping TP fixed.

    TP (model) degree is pinned by the weight sharding already on the
    devices; data-parallel width is shed in whole rows, pods in whole pods.
    Returns (n_pods, data, model); raises if not even one TP group survives.
    """
    if alive_chips < model_degree:
        raise RuntimeError(
            f"only {alive_chips} chips alive; need >= {model_degree} for one "
            f"TP group — unrecoverable without re-sharding weights")
    rows_per_pod = pod_size // model_degree
    full_pods = alive_chips // pod_size
    if full_pods >= 2:
        return full_pods, rows_per_pod, model_degree
    data = min(alive_chips // model_degree, rows_per_pod)
    return 1, data, model_degree


def rebalance_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-replica batch constant when DP width shrinks (the standard
    elastic policy: global batch scales with surviving capacity)."""
    per = global_batch // old_data
    return per * new_data


# ---------------------------------------------------------------------------
# Step guard (checkpoint-on-failure / resume)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepGuard:
    """Run steps with periodic async checkpoints and crash-resume.

    ``save_every`` steps -> async checkpoint; on exception the guard
    synchronously commits the last good state before re-raising, so restart
    resumes at ``latest_step`` with at most ``save_every`` steps recomputed
    (and zero recomputed data — the pipeline is step-seeded).
    """

    checkpointer: "object"            # AsyncCheckpointer
    save_every: int = 100

    def run(self, state, step_fn, batches, n_steps: int, start_step: int = 0,
            on_metrics: Optional[Callable] = None):
        step = start_step
        try:
            for _ in range(n_steps):
                batch = next(batches)
                state, metrics = step_fn(state, batch)
                step += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % self.save_every == 0:
                    self.checkpointer.save(step, state)
        except Exception:
            # best-effort durable state before dying
            self.checkpointer.wait()
            self.checkpointer.save(step, state)
            self.checkpointer.wait()
            raise
        self.checkpointer.wait()
        return state, step
