"""How ``correct`` is decided: the answers the timed path produced, held
against the plain reference.

Every request the run submitted must have an answer. A sample of the
answered requests, drawn from the seed, always with the ragged tail of a
closed loop in it, is recomputed by the configuration's reference
(``reference/<config>.py``) from inputs it makes again from the seed:
the same weights and frames, calibration redone on the same calibration
frames, and for a random output the request's own key. For each output
the number compared is the widest gap between the program's answer and
the reference's, over the sample, as a share of the reference's largest
magnitude in that output. The limits are the configuration's
(``check.limits`` in its file).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import harness
from bench.reference import common

BLOCK = 64


def sample(reqs: List["harness.Req"], n: int, seed: int
           ) -> List["harness.Req"]:
    done = [r for r in reqs if r.answered is not None]
    tail = [r for r in done if r.tail]
    rest = [r for r in done if not r.tail]
    rng = np.random.default_rng(harness.stream_seeds(seed, 5)[4])
    pick = rng.choice(len(rest), size=min(n, len(rest)), replace=False)
    return [rest[i] for i in sorted(pick)] + tail


def reference_outputs(cfg, ref, seed: int, device, picked, bits: int = 8,
                      demoted: Optional[set] = None
                      ) -> Tuple[Dict[str, np.ndarray], set]:
    """The reference's answers to ``picked``, and the layers it kept in
    fp32. Inputs are made again from the seed, on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        inputs = harness.make_inputs(cfg, ref, seed, device)
        qs = common.calibrate(ref.forward, inputs.params, inputs.calib, bits,
                              cfg["ptq_demote_threshold"], demoted)
        keys = None
        if "sample" in ref.OUTPUTS:
            chain = common.ServedKeys(cfg["model"])
            keys = np.stack([chain.layer_key(r.rec_idx, r.rung, r.row)
                             for r in picked])
        idx = torch.tensor([r.frame for r in picked], device=device)
        outs: Dict[str, List[np.ndarray]] = {k: [] for k in ref.OUTPUTS}
        for s in range(0, len(picked), BLOCK):
            sl = idx[s:s + BLOCK]
            batch = {k: v[sl] for k, v in inputs.pool.items()}
            got = ref.forward(inputs.params, batch, qs.serving,
                              None if keys is None else keys[s:s + BLOCK])
            for k in ref.OUTPUTS:
                outs[k].append(got[k].float().cpu().numpy())
        del inputs
    return {k: np.concatenate(v) for k, v in outs.items()}, qs.demoted


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want|; a non-finite answer reads 1e30."""
    got = np.asarray(got, np.float64)
    if not np.all(np.isfinite(got)):
        return 1e30
    top = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / top


def compare(cfg, ref, seed: int, device, reqs, outputs
            ) -> Tuple[Dict[str, list], set]:
    """``{name: [value, limit]}`` for every number compared (the run is
    correct when no value passes its limit), and the layers the
    reference's demotion gate kept in fp32."""
    missing = sum(1 for r in reqs if r.rid not in outputs)
    picked = sample(reqs, cfg["check"]["sample"], seed)
    numbers: Dict[str, list] = {"answers_missing": [missing, 0]}
    if not picked:
        raise RuntimeError("no answered request to check")
    want, demoted = reference_outputs(cfg, ref, seed, device, picked)
    for name in ref.OUTPUTS:
        got = np.stack([np.asarray(outputs[r.rid][name]).reshape(-1)
                        for r in picked])
        numbers[f"{name}_gap"] = [gap(got, want[name].reshape(len(picked), -1)),
                                  cfg["check"]["limits"][name]]
    return numbers, demoted


def control(cfg, ref, seed: int, device, picked) -> Dict[str, float]:
    """The control: the reference in int4, the precision below the
    configuration's, in the program's place, read against the int8
    reference by the same gaps (the int8 run's fp32 layers stay fp32)."""
    want, demoted = reference_outputs(cfg, ref, seed, device, picked)
    got, _ = reference_outputs(cfg, ref, seed, device, picked, bits=4,
                               demoted=demoted)
    return {f"{k}_gap": gap(got[k], want[k]) for k in ref.OUTPUTS}


def passed(numbers: Dict[str, list]) -> bool:
    return all(v <= lim for v, lim in numbers.values())
