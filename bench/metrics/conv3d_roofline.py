"""Flex segments (``core/plan.py: _conv_b``, the library's fp32
``conv3d``): the 3-D convolutions' share of their roofline. The least
time of the configuration's conv3d layers at each traced dispatch's
batch (``counts/conv3d.py``: the larger of the multiply-adds over the
fp32 peak and the bytes over the HBM bandwidth) over the device time of
the library kernels that compute the convolutions, named in
``library/conv3d_f32.json``. The library's layout transforms around them
are not counted here; they stay in ``library_ms.stream`` with the pads,
permutes and pools. None where the stretch ran no such kernel (a program
that serves the 3-D convolutions by another kernel)."""
import json

from bench.harness import BENCH, counts


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None or not tr.rungs:
        return None
    with open(BENCH / "library" / "conv3d_f32.json") as f:
        frags = json.load(f)["match"]
    dev_ns = sum(e.dur_ns for e in tr.device if e.kind == "kernel"
                 and any(frag in e.name for frag in frags))
    layers = [l for l in run.layers if l["op"] == "conv3d"]
    if not layers or dev_ns == 0:
        return None
    c = counts("conv3d")
    least = sum(max(c.mac_ops(l, rung) / run.peaks[l["precision"]],
                    c.nbytes(l, rung) / run.peaks["hbm_bytes_s"])
                for rung, _ in tr.rungs for l in layers)
    return 100.0 * least / (dev_ns / 1e9)
