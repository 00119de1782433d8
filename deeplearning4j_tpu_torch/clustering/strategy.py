"""Pluggable clustering strategy / condition framework.

The port of `deeplearning4j_tpu/clustering/strategy.py` (reference
`clustering/algorithm/`): `BaseClusteringAlgorithm.java:50-174` iterates
{classify points, refresh centers, apply strategy} under a
`ClusteringStrategy` whose pluggable pieces are:

- termination conditions (`condition/FixedIterationCountCondition.java`,
  `ConvergenceCondition.java` point-distribution-change rate,
  `VarianceVariationCondition.java` variance plateau over a period),
- empty-cluster handling + most-spread-cluster splitting
  (`strategy/FixedClusterCountStrategy.java`,
  `ClusterUtils.splitMostSpreadOutClusters`),
- an optimisation phase (`strategy/OptimisationStrategy.java` +
  `optimisation/ClusteringOptimizationType.java`) applied when its own
  condition fires.

Each iteration's assignment, center refresh and `ClusterSetInfo` stats run
on the device (`iterate`); the conditions, the empty-cluster split and the
optimisation strategy are the host-side control loop, as in the JAX
package. The loop reads back the scalars and the per-cluster vectors it
decides on ([k] counts, and the [k] distance stats only when a split is
due); a split moves one row of x into the centers on the device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.cluster import ClusterSet
from deeplearning4j_tpu_torch.clustering.kmeans import (cluster_set,
                                                         kmeanspp_seed,
                                                         points_matrix)
from deeplearning4j_tpu_torch.nd.ops import pairwise_sq_dists
from deeplearning4j_tpu_torch.nd.platform import resolve_device


# ------------------------------------------------------------------ distances

def _manhattan(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[n, k] sums of |x - c| over d, in row blocks of at most 2^26
    elements of the [rows, k, d] differences."""
    k, d = centers.shape
    rows = max(1, (1 << 26) // max(1, k * d))
    return torch.cat([
        torch.sum(torch.abs(x[s:s + rows, None, :] - centers[None, :, :]),
                  dim=-1)
        for s in range(0, x.shape[0], rows)])


def pairwise_distance(x: torch.Tensor, centers: torch.Tensor,
                      distance_fn: str) -> torch.Tensor:
    """[n, k] distances under the strategy's distance function."""
    if distance_fn == "euclidean":
        return torch.sqrt(torch.clamp_min(pairwise_sq_dists(x, centers), 0.0))
    if distance_fn == "manhattan":
        return _manhattan(x, centers)
    if distance_fn == "cosinesimilarity":
        xn = x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True),
                                 1e-12)
        cn = centers / torch.clamp_min(
            torch.linalg.norm(centers, dim=1, keepdim=True), 1e-12)
        return 1.0 - xn @ cn.T
    raise ValueError(f"unknown distance function {distance_fn!r}")


def iterate(x: torch.Tensor, centers: torch.Tensor, prev_assign: torch.Tensor,
            distance_fn: str = "euclidean"):
    """One clustering iteration + its ClusterSetInfo stats, on the device:
    assignment, center refresh (one_hot.T @ x over the counts), the
    point-location-change count (`ClusterSetInfo.getPointLocationChange`),
    the point-to-center distance variance
    (`getPointDistanceFromClusterVariance`), per-cluster counts and
    average/max member distance. Returns (centers, assign, dist, stats),
    all tensors."""
    d = pairwise_distance(x, centers, distance_fn)
    assign = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, assign[:, None])[:, 0]
    one_hot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(
        x.dtype)
    counts = torch.sum(one_hot, dim=0)
    sums = one_hot.T @ x
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts[:, None], 1.0),
                              centers)  # empty cluster keeps its center
    member_d = one_hot * d
    stats = {
        "point_location_change": torch.sum(assign != prev_assign),
        "distance_variance": torch.var(dist, unbiased=False),
        "counts": counts,
        "avg_dist": torch.sum(member_d, dim=0)
        / torch.clamp_min(counts, 1.0),
        "max_dist": torch.max(member_d, dim=0).values,
    }
    return new_centers, assign, dist, stats


# ------------------------------------------------------------ iteration info

@dataclass
class IterationInfo:
    """`iteration/IterationInfo.java`: one iteration's stats snapshot."""

    index: int
    point_location_change: int
    distance_variance: float
    counts: np.ndarray
    strategy_applied: bool = False


@dataclass
class IterationHistory:
    """`iteration/IterationHistory.java`."""

    infos: List[IterationInfo] = field(default_factory=list)

    @property
    def iteration_count(self) -> int:
        return len(self.infos)

    @property
    def most_recent(self) -> Optional[IterationInfo]:
        return self.infos[-1] if self.infos else None


# ---------------------------------------------------------------- conditions

class ClusteringAlgorithmCondition:
    """`condition/ClusteringAlgorithmCondition.java` contract."""

    def is_satisfied(self, history: IterationHistory) -> bool:
        raise NotImplementedError


class FixedIterationCountCondition(ClusteringAlgorithmCondition):
    """True once `iteration_count >= n`
    (`FixedIterationCountCondition.iterationCountGreaterThan`)."""

    def __init__(self, n: int):
        self.n = n

    @classmethod
    def iteration_count_greater_than(cls, n: int):
        return cls(n)

    def is_satisfied(self, history: IterationHistory) -> bool:
        return history.iteration_count >= self.n


class ConvergenceCondition(ClusteringAlgorithmCondition):
    """True when the fraction of points that changed cluster in the last
    iteration drops below `rate`
    (`ConvergenceCondition.distributionVariationRateLessThan`)."""

    def __init__(self, rate: float):
        self.rate = rate

    @classmethod
    def distribution_variation_rate_less_than(cls, rate: float):
        return cls(rate)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= 1:
            return False
        info = history.most_recent
        n_points = int(info.counts.sum())
        return info.point_location_change / max(n_points, 1) < self.rate


class IterationCountMultipleOfCondition(ClusteringAlgorithmCondition):
    """True on every n-th iteration (what the fluent name
    `optimizeWhenIterationCountMultipleOf` promises; the reference's own
    implementation reuses iterationCountGreaterThan, firing on EVERY
    iteration past n — a quirk, not a behavior worth copying)."""

    def __init__(self, n: int):
        self.n = max(1, n)

    def is_satisfied(self, history: IterationHistory) -> bool:
        return (history.iteration_count > 0
                and history.iteration_count % self.n == 0)


class VarianceVariationCondition(ClusteringAlgorithmCondition):
    """True when the relative change of the point-to-center distance
    variance stayed below `threshold` for `period` consecutive
    iterations (`VarianceVariationCondition.varianceVariationLessThan`)."""

    def __init__(self, threshold: float, period: int):
        self.threshold = threshold
        self.period = period

    @classmethod
    def variance_variation_less_than(cls, threshold: float, period: int):
        return cls(threshold, period)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= self.period:
            return False
        infos = history.infos
        for i in range(self.period):
            cur = infos[-1 - i].distance_variance
            prev = infos[-2 - i].distance_variance
            variation = (cur - prev) / prev if prev else 0.0
            if not abs(variation) < self.threshold:
                return False
        return True


# ------------------------------------------------------------- optimisation

class ClusteringOptimizationType(enum.Enum):
    """`optimisation/ClusteringOptimizationType.java`."""

    MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE = "avg_dist"
    MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE = "max_dist"
    MINIMIZE_PER_CLUSTER_POINT_COUNT = "counts"


# ----------------------------------------------------------------- strategy

class ClusteringStrategyType(enum.Enum):
    FIXED_CLUSTER_COUNT = "fixed"
    OPTIMIZATION = "optimization"


class BaseClusteringStrategy:
    """`strategy/BaseClusteringStrategy.java`: cluster count, distance
    function, empty-cluster policy, termination condition — with the
    reference's fluent configuration methods."""

    def __init__(self, type_: ClusteringStrategyType, k: int,
                 distance_fn: str = "euclidean",
                 allow_empty_clusters: bool = False):
        self.type = type_
        self.initial_cluster_count = k
        self.distance_fn = distance_fn
        self.allow_empty_clusters = allow_empty_clusters
        self.termination_condition: Optional[ClusteringAlgorithmCondition] \
            = None

    # fluent configuration (reference method names, snake_cased)
    def end_when_iteration_count_equals(self, n: int):
        self.termination_condition = FixedIterationCountCondition(n)
        return self

    def end_when_distribution_variation_rate_less_than(self, rate: float):
        self.termination_condition = ConvergenceCondition(rate)
        return self

    def end_when_variance_variation_less_than(self, threshold: float,
                                              period: int):
        self.termination_condition = VarianceVariationCondition(
            threshold, period)
        return self

    def is_strategy_of_type(self, t: ClusteringStrategyType) -> bool:
        return self.type == t

    def is_optimization_defined(self) -> bool:
        return False

    def is_optimization_applicable_now(self, history) -> bool:
        return False


class FixedClusterCountStrategy(BaseClusteringStrategy):
    """`strategy/FixedClusterCountStrategy.java`: exactly k clusters; when
    empty clusters are disallowed and appear, the most spread-out
    clusters are split to restore k."""

    def __init__(self, k: int, distance_fn: str = "euclidean",
                 allow_empty_clusters: bool = False):
        super().__init__(ClusteringStrategyType.FIXED_CLUSTER_COUNT, k,
                         distance_fn, allow_empty_clusters)

    @classmethod
    def setup(cls, k: int, distance_fn: str = "euclidean",
              allow_empty_clusters: bool = False):
        return cls(k, distance_fn, allow_empty_clusters)


class OptimisationStrategy(BaseClusteringStrategy):
    """`strategy/OptimisationStrategy.java`: periodically split clusters
    violating an optimisation target (e.g. average member distance above
    a value), under its own application condition."""

    DEFAULT_ITERATIONS = 100

    def __init__(self, k: int, distance_fn: str = "euclidean"):
        super().__init__(ClusteringStrategyType.OPTIMIZATION, k,
                         distance_fn, allow_empty_clusters=False)
        self._opt_type: Optional[ClusteringOptimizationType] = None
        self._opt_value: float = 0.0
        self._application_condition: \
            Optional[ClusteringAlgorithmCondition] = None

    @classmethod
    def setup(cls, k: int, distance_fn: str = "euclidean"):
        return cls(k, distance_fn)

    def optimize(self, type_: ClusteringOptimizationType, value: float):
        self._opt_type = type_
        self._opt_value = value
        return self

    def optimize_when_iteration_count_multiple_of(self, n: int):
        self._application_condition = IterationCountMultipleOfCondition(n)
        return self

    def optimize_when_point_distribution_variation_rate_less_than(
            self, rate: float):
        self._application_condition = ConvergenceCondition(rate)
        return self

    def is_optimization_defined(self) -> bool:
        return self._opt_type is not None

    def is_optimization_applicable_now(self, history) -> bool:
        return (self._application_condition is not None
                and self._application_condition.is_satisfied(history))


# ---------------------------------------------------------------- algorithm

class BaseClusteringAlgorithm:
    """`BaseClusteringAlgorithm.java:50-174` control loop on the device
    iteration: init centers (k-means++ D^2 sampling, same as the
    reference's initClusters), then {iterate, record history, apply
    strategy} until the termination condition fires. Runs on `device`
    (CUDA unless the caller passes "cpu")."""

    def __init__(self, strategy: BaseClusteringStrategy, seed: int = 0,
                 device=None):
        self.strategy = strategy
        # default termination lives on the ALGORITHM — writing it into
        # the (possibly shared) strategy object would change the stopping
        # behavior of other algorithms built from the same strategy
        self._termination = (strategy.termination_condition
                             or FixedIterationCountCondition(
                                 OptimisationStrategy.DEFAULT_ITERATIONS))
        self.seed = seed
        self.device = resolve_device(device)
        self.history = IterationHistory()

    @classmethod
    def setup(cls, strategy: BaseClusteringStrategy, seed: int = 0,
              device=None):
        return cls(strategy, seed, device)

    # -- pieces ------------------------------------------------------------
    def _init_centers(self, x: torch.Tensor,
                      rng: np.random.RandomState) -> torch.Tensor:
        return kmeanspp_seed(x, self.strategy.initial_cluster_count, rng)

    @staticmethod
    def _split_cluster(centers: torch.Tensor, x: torch.Tensor,
                       assign: torch.Tensor, dist: torch.Tensor,
                       source: int, target: int) -> torch.Tensor:
        """Split cluster `source`: its farthest member (the first of equal
        ones) becomes the new center of slot `target`
        (`ClusterUtils.splitMostSpreadOutClusters` analog — reseeds an
        empty/violating slot from the widest cluster's rim). The caller
        knows the cluster has members."""
        members = assign == source
        far = torch.argmax(torch.where(members, dist,
                                       torch.full_like(dist, -np.inf)))
        centers = centers.clone()
        centers[target] = x[far]
        return centers

    def _apply_strategy(self, centers, x, assign, dist, stats,
                        counts: np.ndarray):
        """Empty-cluster repair + optimisation phase; returns
        (centers, strategy_applied) — the flag feeds
        `IterationInfo.strategyApplied`. `counts` is stats["counts"] on
        the host."""
        applied = False
        if not self.strategy.allow_empty_clusters:
            empties = np.where(counts == 0)[0]
            if len(empties):
                # FIXED_CLUSTER_COUNT restores k by splitting the most
                # spread-out clusters into the empty slots; a source must
                # have >1 member AND nonzero spread (splitting a cluster
                # of identical points re-creates the same center), and
                # repair that makes no progress must not count as applied
                # (it would defeat the termination condition); max_dist is
                # a cluster's largest member distance, 0 when it has none
                avg = stats["avg_dist"].cpu().numpy()
                far = stats["max_dist"].cpu().numpy()
                order = [int(s) for s in np.argsort(-avg)
                         if counts[s] > 1 and max(far[s], 0.0) > 0]
                for slot, source in zip(empties, order):
                    centers = self._split_cluster(
                        centers, x, assign, dist, source, int(slot))
                    applied = True
        if (self.strategy.is_optimization_defined()
                and self.history.iteration_count != 0
                and self.strategy.is_optimization_applicable_now(
                    self.history)):
            metric = stats[self.strategy._opt_type.value].cpu().numpy(
            ).astype(np.float64)
            violating = np.where(metric > self.strategy._opt_value)[0]
            # each split consumes its target slot (working copy of the
            # counts), so several violating clusters split into DISTINCT
            # least-loaded slots instead of overwriting one
            counts_left = counts.astype(np.float64).copy()
            for source in violating:
                if counts[int(source)] == 0:
                    continue
                order = np.argsort(counts_left)
                target = next((int(t) for t in order
                               if int(t) != int(source)
                               and np.isfinite(counts_left[t])), None)
                if target is None:
                    break
                centers = self._split_cluster(
                    centers, x, assign, dist, int(source), target)
                counts_left[target] = np.inf
                applied = True
        return centers, applied

    # -- the loop ----------------------------------------------------------
    def fit(self, x):
        """Cluster an (n, d) matrix (numpy or tensor): (centers [k, d],
        assignment [n]) on the device; `history` holds the iterations."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        k = self.strategy.initial_cluster_count
        if x.shape[0] < k:
            raise ValueError(f"need >= k={k} points, got {x.shape[0]}")

        rng = np.random.RandomState(self.seed)
        centers = self._init_centers(x, rng)
        assign = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        self.history = IterationHistory()
        cond = self.strategy.termination_condition or self._termination

        # hard backstop: a strategy that fires every iteration (e.g. an
        # unsatisfiable optimisation target) must not loop forever — the
        # reference has no such guard and can spin; 1000 >> any real run
        while ((not cond.is_satisfied(self.history)
                or (self.history.most_recent is not None
                    and self.history.most_recent.strategy_applied))
               and self.history.iteration_count < 1000):
            centers, assign, dist, stats = iterate(
                x, centers, assign, self.strategy.distance_fn)
            counts = stats["counts"].cpu().numpy()
            info = IterationInfo(
                index=self.history.iteration_count,
                point_location_change=int(stats["point_location_change"]),
                distance_variance=float(stats["distance_variance"]),
                counts=counts)
            centers, info.strategy_applied = self._apply_strategy(
                centers, x, assign, dist, stats, counts)
            self.history.infos.append(info)

        # final classification against the settled centers
        _, assign, _, _ = iterate(x, centers, assign,
                                  self.strategy.distance_fn)
        return centers, assign

    def apply_to(self, points) -> ClusterSet:
        pts, x = points_matrix(points)
        k = self.strategy.initial_cluster_count
        if len(pts) < k:
            raise ValueError(f"need >= k={k} points, got {len(pts)}")
        centers, assign = self.fit(x)
        return cluster_set(pts, centers.cpu().numpy(), assign.cpu().numpy())
