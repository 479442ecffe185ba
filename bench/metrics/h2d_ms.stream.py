"""Pipeline layer (``core/pipeline.py``, the staging copy): device time of
host-to-device copies in the traced stretch, per dispatch."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_dispatches == 0:
        return None
    ns = sum(e.dur_ns for e in tr.device if e.kind == "h2d")
    return ns / 1e6 / tr.n_dispatches if ns else None
