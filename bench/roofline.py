"""A layer kind's share of its roofline in a traced stretch: the least
time of the configuration's layers of that kind, at each traced
dispatch's batch, over the device time of the hand-written kernels that
run them. A layer's least time is the larger of its multiply-add
operations over the peak of its precision and its bytes over the HBM
bandwidth (``chip_smoke.py: bound_ms``). The kernels are found by the
families in ``bench/kernels/`` that name the same layer kind and
precision, so a renamed or new kernel joins by a file of its own."""
from __future__ import annotations

from bench.harness import counts, handwritten_kernels


def share(run, layer_op: str, precision: str):
    tr = run.trace
    if tr is None or run.peaks is None or not tr.rungs:
        return None
    frags = [f for fam in handwritten_kernels()
             if fam["layer_op"] == layer_op and fam["precision"] == precision
             for f in fam["match"]]
    dev_ns = sum(e.dur_ns for e in tr.device if e.kind == "kernel"
                 and any(f in e.name for f in frags))
    layers = [l for l in run.layers
              if l["op"] == layer_op and l["precision"] == precision]
    if not layers or dev_ns == 0:
        return None
    c = counts(layer_op)
    peak = run.peaks[precision]
    least = sum(max(c.mac_ops(l, rung) / peak,
                    c.nbytes(l, rung) / run.peaks["hbm_bytes_s"])
                for rung, _ in tr.rungs for l in layers)
    return 100.0 * least / (dev_ns / 1e9)
