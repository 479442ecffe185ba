"""What every system's check shares: the sample of answered requests that
the reference recomputes, the gap by which an answer is judged, and the
verdict.

The sample is drawn from the seed, always with the ragged tail of a
closed loop in it. Each system's ``compare`` (``systems/<system>.py``)
recomputes it with the configuration's plain reference and returns its
numbers beside their limits; a run is correct when no number passes its
limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench import harness

BLOCK = 64


def sample(reqs: List["harness.Req"], n: int, seed: int
           ) -> List["harness.Req"]:
    done = [r for r in reqs if r.answered is not None]
    tail = [r for r in done if r.tail]
    rest = [r for r in done if not r.tail]
    rng = np.random.default_rng(harness.stream_seeds(seed, 5)[4])
    pick = rng.choice(len(rest), size=min(n, len(rest)), replace=False)
    return [rest[i] for i in sorted(pick)] + tail


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over max |want|; a non-finite answer reads 1e30."""
    got = np.asarray(got, np.float64)
    if not np.all(np.isfinite(got)):
        return 1e30
    top = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / top


def passed(numbers: Dict[str, list]) -> bool:
    return all(v <= lim for v, lim in numbers.values())
