"""K-means clustering on the device.

The port of `deeplearning4j_tpu/clustering/kmeans.py` (reference
`clustering/kmeans/KMeansClustering.java`, a facade on
`clustering/algorithm/BaseClusteringAlgorithm.java`): iterate {assign
points to the nearest center, recompute centers} until the centers stop
moving (max row shift <= tol) or `max_iterations` is reached.

Each Lloyd iteration runs on the device: the squared distances through one
matrix product (|x|^2 - 2 x.c^T + |c|^2), the argmin, and the center update
as one_hot.T @ x over the counts (an empty cluster keeps its center). The
JAX package runs the whole loop as one `lax.while_loop`; here the host
reads the scalar shift back once an iteration to decide whether to go on,
with the same test (float32 shift > float32 tol), so the iteration count
is the JAX package's.

The k-means++ seeding draws from the same `RandomState` as the JAX
package's host code; its D^2 updates run on the points' device in numpy's
summation order (`row_sq_dists`), so the seeds are the same rows, and
only the 4 bytes a point of D^2 come back to the host for each draw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.cluster import (Cluster,
                                                          ClusterSet, Point)
from deeplearning4j_tpu_torch.nd.ops import pairwise_sq_dists
from deeplearning4j_tpu_torch.nd.platform import resolve_device


def _numpy_sum(a: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's sum of a[:, :n] in numpy's order (`pairwise_sum` of its
    float loops: eight running sums over blocks of up to 128, combined as
    a tree, the rest one by one; longer rows split in halves at a multiple
    of 8), so that a float32 row sum is bitwise numpy's."""
    if n < 8:
        res = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        r = a[:, 0:8]
        m = n - n % 8
        for i in range(8, m, 8):
            r = r + a[:, i:i + 8]
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for i in range(m, n):
            res = res + a[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _numpy_sum(a[:, :n2], n2) + _numpy_sum(a[:, n2:], n - n2)


def row_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """((x - c) ** 2).sum(1) for x [n, d] and one row c [d], bitwise what
    numpy computes for float32 arrays."""
    diff = x - c[None, :]
    return _numpy_sum(diff * diff, x.shape[1])


def kmeanspp_seed(x, k: int, rng: np.random.RandomState):
    """k-means++ D^2-weighted seeding (k draws over n). Shared by the fast
    path below and the strategy framework
    (`clustering/strategy.BaseClusteringAlgorithm`). `x` is a tensor (D^2
    on its device) or a numpy matrix (D^2 on the CPU); the centers come
    back as the same kind, the rows the draws picked."""
    if not isinstance(x, torch.Tensor):
        return kmeanspp_seed(torch.as_tensor(np.asarray(x)), k, rng).numpy()
    n = x.shape[0]
    picks = [rng.randint(n)]
    d2 = row_sq_dists(x, x[picks[0]])
    for _ in range(1, k):
        d2_host = d2.cpu().numpy()
        total = d2_host.sum()
        if total <= 0:  # all remaining points coincide with a center
            picks.append(rng.randint(n))
            continue
        i = int(rng.choice(n, p=d2_host / total))
        picks.append(i)
        d2 = torch.minimum(d2, row_sq_dists(x, x[i]))
    return x[torch.as_tensor(picks, device=x.device)]


def _update(x: torch.Tensor, centers: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd step: (new centers, assignment)."""
    d = pairwise_sq_dists(x, centers)
    assign = torch.argmin(d, dim=1)
    one_hot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(
        x.dtype)
    counts = torch.sum(one_hot, dim=0)
    sums = one_hot.T @ x
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts[:, None], 1.0),
                      centers)  # empty cluster keeps its center
    return new, assign


def lloyd(x: torch.Tensor, init_centers: torch.Tensor, max_iters: int,
          tol: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The Lloyd loop: while (shift > tol and iterations < max_iters), the
    shift the largest distance a center moved, in float32 as the JAX
    package compares it. Returns (centers, the assignment to them, the
    iterations run)."""
    tol32 = float(np.float32(tol))
    centers, it, moved = init_centers, 0, float("inf")
    while moved > tol32 and it < max_iters:
        new, _ = _update(x, centers)
        moved = float(torch.max(torch.linalg.norm(new - centers, dim=1)))
        centers, it = new, it + 1
    # final assignment against the converged centers
    _, assign = _update(x, centers)
    return centers, assign, it


def points_matrix(points) -> Tuple[list, np.ndarray]:
    """(Points, float32 matrix) of a list of Points or an (n, d) matrix."""
    if isinstance(points, (np.ndarray, torch.Tensor)):
        pts = Point.to_points(np.asarray(points))
    else:
        pts = list(points)
    return pts, np.stack([p.array for p in pts]).astype(np.float32)


def cluster_set(pts, centers: np.ndarray, assign: np.ndarray) -> ClusterSet:
    """The ClusterSet of k centers and the points' assignment."""
    clusters = [Cluster(id=i, center=centers[i]) for i in range(len(centers))]
    cs = ClusterSet(clusters=clusters)
    for p, a in zip(pts, assign):
        clusters[int(a)].points.append(p)
        cs.assignments[p.id] = int(a)
    return cs


class KMeansClustering:
    """`KMeansClustering.setup(k, maxIters, distanceFn)` parity facade.

    This class is the fast path (the Lloyd loop on the device). The
    reference's two `setup` overloads return the pluggable
    `BaseClusteringAlgorithm` (strategy framework, empty-cluster repair,
    optimisation phase) from `clustering/strategy.py`. Runs on `device`
    (CUDA unless the caller passes "cpu")."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 seed: int = 0, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.iterations = 0

    @staticmethod
    def setup(k: int, max_iterations: int = None,
              distance_fn: str = "euclidean",
              min_distribution_variation_rate: float = None,
              allow_empty_clusters: bool = False, seed: int = 0,
              device=None):
        """`KMeansClustering.setup` parity (both Java overloads): returns
        a strategy-driven `BaseClusteringAlgorithm` terminating either on
        iteration count or on distribution-variation convergence."""
        from deeplearning4j_tpu_torch.clustering.strategy import (
            BaseClusteringAlgorithm, FixedClusterCountStrategy)

        strat = FixedClusterCountStrategy.setup(k, distance_fn,
                                                allow_empty_clusters)
        if min_distribution_variation_rate is not None:
            strat.end_when_distribution_variation_rate_less_than(
                min_distribution_variation_rate)
        else:
            strat.end_when_iteration_count_equals(max_iterations or 100)
        return BaseClusteringAlgorithm.setup(strat, seed=seed, device=device)

    def fit(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cluster an (n, d) matrix (numpy or tensor): (centers [k, d],
        assignment [n]) on the device; `iterations` holds the count."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape[0] < self.k:
            raise ValueError(f"need >= k={self.k} points, got {x.shape[0]}")
        init = kmeanspp_seed(x, self.k, np.random.RandomState(self.seed))
        centers, assign, self.iterations = lloyd(
            x, init, self.max_iterations, self.tol)
        return centers, assign

    def apply_to(self, points) -> ClusterSet:
        """Cluster a list of Points or an (n,d) matrix → ClusterSet."""
        pts, x = points_matrix(points)
        if len(pts) < self.k:
            raise ValueError(f"need >= k={self.k} points, got {len(pts)}")
        centers, assign = self.fit(x)
        return cluster_set(pts, centers.cpu().numpy(), assign.cpu().numpy())
