"""Vantage-point tree for metric nearest-neighbor search.

Parity: reference `clustering/vptree/VPTree.java` (316 LoC — median-split
VP tree, euclidean or cosine-similarity "distance", k-NN search with a
tau-shrinking priority queue). Backs the UI `NearestNeighborsResource` and
Barnes-Hut t-SNE input neighborhoods.

The cosine mode uses *angular* distance (arccos of cosine similarity) —
a true metric, unlike 1-cos, so the tau triangle-inequality pruning stays
correct; the neighbor ordering is identical (arccos is monotone).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


def _euclidean_batch(items: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.linalg.norm(items - v[None, :], axis=1)


def _angular_batch(items: np.ndarray, v: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(items, axis=1) * max(np.linalg.norm(v), 1e-12)
    cos = (items @ v) / np.maximum(norms, 1e-12)
    return np.arccos(np.clip(cos, -1.0, 1.0))


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional[_VPNode] = None
        self.outside: Optional[_VPNode] = None


class VPTree:
    """`VPTree(items, similarityFunction)` parity; "euclidean" (default) or
    "cosine" metric (implemented as angular distance, same ordering)."""

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self._dist_batch = (_euclidean_batch if distance == "euclidean"
                            else _angular_batch)
        self._rng = np.random.RandomState(seed)
        self.root = self._build(np.arange(len(self.items)))

    def _dist(self, i: int, target: np.ndarray) -> float:
        return float(self._dist_batch(self.items[i:i + 1], target)[0])

    def _build(self, idx: np.ndarray) -> Optional[_VPNode]:
        if len(idx) == 0:
            return None
        vp = int(idx[self._rng.randint(len(idx))])
        rest = idx[idx != vp]
        node = _VPNode(vp)
        if len(rest):
            dists = self._dist_batch(self.items[rest], self.items[vp])
            node.threshold = float(np.median(dists))
            node.inside = self._build(rest[dists < node.threshold])
            node.outside = self._build(rest[dists >= node.threshold])
        return node

    def knn(self, target, k: int) -> List[Tuple[float, int]]:
        """k nearest as (distance, item-index), ascending by distance."""
        target = np.asarray(target, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negative distance
        tau = [np.inf]

        def rec(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist(node.index, target)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if d < node.threshold:
                rec(node.inside)
                if d + tau[0] >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau[0] <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        return sorted(((-nd, i) for nd, i in heap), key=lambda t: t[0])

    def words_nearest(self, target, k: int) -> List[int]:
        """Indices of the k nearest items (UI nearest-neighbors contract)."""
        return [i for _, i in self.knn(target, k)]
