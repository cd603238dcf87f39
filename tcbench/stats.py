"""Order statistics of the benchmark, frozen."""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


# copied from port/repro_torch/serve/engine.py ``percentiles`` (the pick)
def percentile(samples: Sequence[float], q: float) -> float:
    """The ``q`` quantile of ``samples``: the sample at ``int(q·n)`` of
    the sorted samples (clamped to the last)."""
    xs = np.sort(np.asarray(samples, np.float64))
    return float(xs[min(len(xs) - 1, int(q * len(xs)))])


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (Python's ``statistics.quantiles``, n = 4)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
