"""The 95th percentile, over every request due inside the window, of the
time from when it was due to its answer on the host (the retirement of its
dispatch); a request never answered counts the wait until the run gave
up on it."""
import numpy as np


def read(run):
    lat = [run.latency_s(r) for r in run.due_in_window]
    if not lat:
        return None
    return float(np.percentile(lat, 95) * 1e3)
