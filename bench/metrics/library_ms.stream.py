"""Plan layer (``core/plan.py``): device time, per dispatch, of every
kernel in the traced stretch that is not one of the port's hand-written
kernels (``bench/kernels/*.json``): pools, casts, the activation
quantizer's elementwise steps, pads, library convolutions."""
from bench.harness import handwritten_kernels


def read(run):
    tr = run.trace
    if tr is None or tr.n_dispatches == 0:
        return None
    frags = [f for fam in handwritten_kernels() for f in fam["match"]]
    ns = sum(e.dur_ns for e in tr.device if e.kind == "kernel"
             and not any(f in e.name for f in frags))
    return ns / 1e6 / tr.n_dispatches if ns else None
