"""Pipeline layer (``core/pipeline.py`` and the scheduler's ticket
retirement): the median, over requests due in the window before any
traced stretch, of the answer's time on the host minus its dispatch's
time. Pipelined dispatch retires a ticket only when a later dispatch
needs its staging slot, so this holds the wait for the next frames."""
import numpy as np


def read(run):
    w = [r.answered - r.dispatched for r in run.untraced(run.due_in_window)
         if r.answered is not None and r.dispatched is not None]
    return float(np.median(w) * 1e3) if w else None
