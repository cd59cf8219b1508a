"""Two-sample checks of a sampled accuracy against the JAX package's.

The port and the JAX package draw from different streams (Philox against
threefry), so a sampled RMSE matches only in distribution. These tests
decide whether the port's values could come from the JAX package's
distribution; a p-value under ``P_MIN`` flags a shift (the MAT column's
rank test uses the same bar).
"""

from __future__ import annotations

import math
import statistics

P_MIN = 1e-3


def _p(z: float) -> float:
    """Two-sided normal p-value of ``z``."""
    return math.erfc(abs(z) / math.sqrt(2.0))


def welch_z(values, ref_mean: float, ref_sd: float, ref_n: int):
    """(z, p) of the mean of ``values`` against a reference sample given
    by its mean, standard deviation and size (Welch's standard error)."""
    n = len(values)
    se = math.sqrt(statistics.variance(values) / n + ref_sd**2 / ref_n)
    z = (statistics.fmean(values) - ref_mean) / se
    return z, _p(z)


def reference_sd_z(values, ref_mean: float, ref_sd: float, ref_n: int):
    """(z, p) of the mean of ``values`` against a reference sample, both
    samples' spread taken as the reference's standard deviation (the same
    distribution under the null). For a few values, whose own standard
    deviation is too noisy for :func:`welch_z`."""
    se = ref_sd * math.sqrt(1.0 / len(values) + 1.0 / ref_n)
    z = (statistics.fmean(values) - ref_mean) / se
    return z, _p(z)


def paired_z(values, ref_values):
    """(z, p) of the mean difference of paired samples (the same runs on
    the same data)."""
    diffs = [a - b for a, b in zip(values, ref_values)]
    se = statistics.stdev(diffs) / math.sqrt(len(diffs))
    z = statistics.fmean(diffs) / se
    return z, _p(z)


def summary(values):
    """(mean, standard deviation, size) of a sample."""
    return statistics.fmean(values), statistics.stdev(values), len(values)
