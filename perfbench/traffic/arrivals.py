"""Open-loop arrival schedules.

``poisson`` is the Poisson mode of ``repro_torch.engine.chaos.
synth_arrival_trace``: i.i.d. exponential gaps at ``rate`` requests a
second.  The gaps are drawn as the exponential law's quantiles and shuffled
by the seed, so that every seed offers the same set of gaps (the same load
and the same bursts, in another order) and runs of different seeds differ
no more than two runs of one seed.
"""

from __future__ import annotations

import numpy as np


def poisson(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of the arrivals in
    ``[0, seconds)`` at mean ``rate``."""
    n = int(np.ceil(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    np.random.default_rng(seed).shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0]
    return due[due < seconds]
