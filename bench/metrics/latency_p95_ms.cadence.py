"""The single-frame cells' tail, per layer: ``latency_p95_ms`` (due time
to answer on the host, a request never answered counting the wait until
the run gave up) over the requests due in the window before any traced
stretch. In these cells the p95 moves by 13-22% from run to run with
the host behind the card, more than half of the widest bound (25%), so
it is read here and held by no bound."""
import numpy as np


def read(run):
    lat = [run.latency_s(r) for r in run.untraced(run.due_in_window)]
    if not lat:
        return None
    return float(np.percentile(lat, 95) * 1e3)
