"""Order statistics the benchmark reports and bounds with."""

from __future__ import annotations

import math
import statistics

import numpy as np


def percentile_ms(seconds, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``seconds``, in ms: the
    smallest sample with at least ``q`` % of the samples at or below it."""
    xs = np.sort(np.asarray(seconds, dtype=np.float64))
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return 1e3 * float(xs[rank - 1])


def spread(values) -> float:
    """The distance between the first and third quartiles (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
