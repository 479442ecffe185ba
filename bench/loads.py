"""Arrival schedules of the open loop.

The program's ``core/scheduler.poisson_arrivals`` draws a fresh set of
exponential gaps from each seed, so two seeds offer different amounts of
work in a window. :func:`fixed_set_poisson` gives every seed the same set
of gaps (the exponential distribution's quantiles) in an order drawn from
the seed: two seeds offer the same work and differ only in when it comes.
"""
from __future__ import annotations

import numpy as np


def fixed_set_poisson(rate_hz: float, n: int, seed: int) -> np.ndarray:
    """``n + 1`` arrival offsets whose ``n`` gaps are the exponential
    distribution's quantiles at ``(i + 1/2) / n``, shuffled by ``seed``;
    the first request is due at offset 0."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    gaps = -np.log1p(-q) / rate_hz
    np.random.default_rng(seed).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)])
