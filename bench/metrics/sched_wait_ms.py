"""Scheduler layer (``core/scheduler.py``): the median, over requests due
in the window before any traced stretch, of the dispatch record's time
(``DispatchRecord.started``) minus the request's due time: how long a
frame waits for the dispatcher to pick it up."""
import numpy as np


def read(run):
    w = [r.dispatched - r.due for r in run.untraced(run.due_in_window)
         if r.dispatched is not None]
    return float(np.median(w) * 1e3) if w else None
