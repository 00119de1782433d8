"""Math/stats helpers.

Parity: reference `util/MathUtils.java` (1,293 LoC) — the subset actually
used elsewhere in the reference (normalization, entropy/information gain,
correlation, distances, rounding, sampling odds) plus the
`berkeley/SloppyMath.java` log-space helpers. Vectorized numpy throughout;
anything hot enough for a device belongs in `nd/ops.py` instead.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def normalize(val: float, min_v: float, max_v: float) -> float:
    """Squash val from [min, max] into [0, 1] (`MathUtils.normalize`)."""
    if max_v == min_v:
        return 0.0
    return (val - min_v) / (max_v - min_v)


def clamp(val: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, val))


def round_to_n_decimals(x: float, n: int) -> float:
    return float(np.round(x, n))


def entropy(probs: Sequence[float]) -> float:
    """Shannon entropy in nats over a probability vector."""
    p = np.asarray(probs, np.float64)
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def information_gain(parent: Sequence[float],
                     children: Sequence[Sequence[float]],
                     weights: Sequence[float]) -> float:
    """Entropy(parent) - sum_i w_i * Entropy(child_i)."""
    return entropy(parent) - sum(
        w * entropy(c) for w, c in zip(weights, children))


def ssum(x: Sequence[float]) -> float:
    return float(np.sum(np.asarray(x, np.float64)))


def sum_of_squares(x: Sequence[float]) -> float:
    a = np.asarray(x, np.float64)
    return float((a * a).sum())


def mean(x: Sequence[float]) -> float:
    return float(np.mean(np.asarray(x, np.float64)))


def variance(x: Sequence[float]) -> float:
    """Sample variance (n-1 denominator, `MathUtils.variance` parity)."""
    a = np.asarray(x, np.float64)
    if len(a) < 2:
        return 0.0
    return float(a.var(ddof=1))


def correlation(a: Sequence[float], b: Sequence[float]) -> float:
    """Pearson correlation coefficient."""
    return float(np.corrcoef(np.asarray(a, np.float64),
                             np.asarray(b, np.float64))[0, 1])


def euclidean_distance(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) -
                                np.asarray(b, np.float64)))


def manhattan_distance(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).sum())


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def log_add(log_a: float, log_b: float) -> float:
    """log(exp(a) + exp(b)) without overflow (`SloppyMath.logAdd`)."""
    if log_a == -np.inf:
        return log_b
    if log_b == -np.inf:
        return log_a
    m = max(log_a, log_b)
    return m + math.log(math.exp(log_a - m) + math.exp(log_b - m))


def log_sum(log_values: Sequence[float]) -> float:
    a = np.asarray(log_values, np.float64)
    if len(a) == 0:
        return -np.inf
    m = a.max()
    if m == -np.inf:
        return -np.inf
    return float(m + np.log(np.exp(a - m).sum()))


def bernoullis(success_prob: float, trials: int, successes: int) -> float:
    """Binomial pmf P(successes | trials, p) (`MathUtils.bernoullis`)."""
    return float(math.comb(trials, successes) *
                 success_prob ** successes *
                 (1 - success_prob) ** (trials - successes))


def discretize(value: float, lo: float, hi: float, bins: int) -> int:
    """Map value in [lo, hi] to a bin index (`MathUtils.discretize`)."""
    if hi == lo:
        return 0
    frac = (value - lo) / (hi - lo)
    return int(clamp(math.floor(frac * bins), 0, bins - 1))


def next_power_of_2(n: int) -> int:
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


def xor_sample(shape, rng: np.random.RandomState):
    """XOR toy dataset (`MathUtils.xorData` parity): returns (x, y)."""
    x = rng.randint(0, 2, shape).astype(np.float32)
    y = (x.sum(axis=-1) % 2).astype(np.float32)
    return x, y
