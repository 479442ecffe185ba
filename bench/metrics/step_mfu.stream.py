"""The whole served step: inferences dispatched in the traced stretch
times the least time of one inference at the card's published peaks,
over the card's busy time in the stretch (the union of its device
events), in percent. At a fixed offered rate the stretch's length is
set by the arrivals, so the busy time is the time the step's work took.
Each layer's operations (as the graph counts them) run at the peak of
the precision the int8 plan gives it: int8 for the convolutions and
dense layers with their fused epilogues, fp32 for the pools and the
sample."""
from bench.harness import counts


def read(run):
    tr = run.trace
    if tr is None or run.peaks is None or not tr.device:
        return None
    per_inf = sum(counts(l["op"]).ops(l, 1) / run.peaks[l["precision"]]
                  for l in run.layers)
    n = sum(n_real for _, n_real in tr.rungs)
    return 100.0 * n * per_inf / tr.busy_s if n and tr.busy_s > 0 else None
