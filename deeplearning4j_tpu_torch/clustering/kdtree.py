"""KD-tree for exact nearest-neighbor queries.

Parity: reference `clustering/kdtree/KDTree.java` (370 LoC — insert, nn
query, knn, range query over a k-d binary space partition).

A copy of the JAX package's tree. Host-side index (numpy): tree search is
pointer-chasing, which has no device formulation worth a kernel; the bulk
distance math that does belong on the card lives in `kmeans.py` /
`plot/tsne.py`.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "index", "dim", "left", "right")

    def __init__(self, point, index, dim):
        self.point = point
        self.index = index
        self.dim = dim
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    @staticmethod
    def build(data: np.ndarray) -> "KDTree":
        """Balanced bulk build by median splitting."""
        data = np.asarray(data, np.float64)
        tree = KDTree(data.shape[1])

        def rec(idx: np.ndarray, depth: int) -> Optional[_Node]:
            if len(idx) == 0:
                return None
            dim = depth % tree.dims
            order = idx[np.argsort(data[idx, dim], kind="stable")]
            mid = len(order) // 2
            node = _Node(data[order[mid]], int(order[mid]), dim)
            node.left = rec(order[:mid], depth + 1)
            node.right = rec(order[mid + 1:], depth + 1)
            return node

        tree.root = rec(np.arange(len(data)), 0)
        tree.size = len(data)
        return tree

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64)
        self.size += 1
        if self.root is None:
            self.root = _Node(point, self.size - 1, 0)
            return
        node, depth = self.root, 0
        while True:
            side = point[node.dim] < node.point[node.dim]
            child = node.left if side else node.right
            if child is None:
                new = _Node(point, self.size - 1, (depth + 1) % self.dims)
                if side:
                    node.left = new
                else:
                    node.right = new
                return
            node, depth = child, depth + 1

    def nn(self, target) -> Tuple[float, np.ndarray]:
        """Nearest neighbor: (distance, point)."""
        d, pt, _ = self.knn(target, 1)[0]
        return d, pt

    def knn(self, target, k: int) -> List[Tuple[float, np.ndarray, int]]:
        """k nearest: list of (distance, point, index), ascending."""
        target = np.asarray(target, np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap via -dist

        def rec(node: Optional[_Node]):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - target))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index, node.point))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index, node.point))
            diff = target[node.dim] - node.point[node.dim]
            near, far = (node.left, node.right) if diff < 0 else \
                        (node.right, node.left)
            rec(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far)

        rec(self.root)
        out = sorted(((-nd, pt, i) for nd, i, pt in heap), key=lambda t: t[0])
        return [(d, pt, i) for d, pt, i in out]

    def range(self, lower, upper) -> List[Tuple[np.ndarray, int]]:
        """All points inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[Tuple[np.ndarray, int]] = []

        def rec(node: Optional[_Node]):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append((node.point, node.index))
            if node.point[node.dim] >= lower[node.dim]:
                rec(node.left)
            if node.point[node.dim] <= upper[node.dim]:
                rec(node.right)

        rec(self.root)
        return out
