"""``sched_wait_ms`` in the single-frame cells, whose end-to-end metrics
are the energy per inference and the set-up time: the same reading, under
a name of its own because it names another end-to-end metric there."""
from bench import harness


def read(run):
    return harness.metric_reader("sched_wait_ms").read(run)
