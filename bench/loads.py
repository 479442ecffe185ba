"""Arrival schedules of the open loop.

The program's ``core/scheduler.poisson_arrivals`` draws a fresh set of
exponential gaps from each seed, so two seeds offer different amounts of
work in a window. :func:`fixed_set_poisson` gives every seed the same set
of gaps (the exponential distribution's quantiles) in an order drawn from
the seed: two seeds offer the same work and differ only in when it comes.
:func:`window_arrivals` keeps the window's gaps a set of their own, so
that the count due inside the window does not depend on the seed either.
"""
from __future__ import annotations

import math

import numpy as np


def fixed_set_poisson(rate_hz: float, n: int, seed: int) -> np.ndarray:
    """``n + 1`` arrival offsets whose ``n`` gaps are the exponential
    distribution's quantiles at ``(i + 1/2) / n``, shuffled by ``seed``;
    the first request is due at offset 0."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    gaps = -np.log1p(-q) / rate_hz
    np.random.default_rng(seed).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)])


def window_arrivals(rate_hz: float, seconds: float, grace_s: float,
                    seed: int) -> np.ndarray:
    """Arrival offsets for a window of ``seconds`` and ``grace_s`` after
    it. The window's ``rate_hz * seconds`` gaps are one fixed set and the
    grace period's another, each shuffled by the seed, so every seed has
    the same arrivals due in the window, give or take the few grace
    arrivals that land before its close (one shuffle of all the gaps
    together moved the count by about 1% a seed at 100/s)."""
    n_win = int(round(rate_hz * seconds))
    n_grace = int(math.ceil(rate_hz * grace_s)) + 1
    rng = np.random.default_rng(seed)
    win = fixed_set_poisson(rate_hz, n_win, int(rng.integers(2 ** 62)))
    grace = fixed_set_poisson(rate_hz, n_grace, int(rng.integers(2 ** 62)))
    return np.concatenate([win, win[-1] + grace[1:]])
