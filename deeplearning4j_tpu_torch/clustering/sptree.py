"""N-dimensional space-partitioning tree (generalized octree).

Parity: reference `clustering/sptree/SpTree.java` (365 LoC — 2^d children
per node, center-of-mass accumulation, Barnes-Hut non-edge forces with
theta approximation, edge forces from a sparse P matrix). Used by
`BarnesHutTsne`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

NODE_RATIO = 0.5  # reference SpTree theta comparison uses max cell width


class SpTree:
    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)  # half-widths per dim
        self.d = len(self.center)
        self.center_of_mass = np.zeros(self.d)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.children: Optional[List[Optional[SpTree]]] = None

    @staticmethod
    def build(data: np.ndarray) -> "SpTree":
        data = np.asarray(data, np.float64)
        mean = data.mean(axis=0)
        half = np.maximum(np.abs(data - mean).max(axis=0), 1e-5) + 1e-5
        tree = SpTree(mean, half)
        for p in data:
            tree.insert(p)
        return tree

    @property
    def is_leaf(self) -> bool:
        return self.children is None

    def _contains(self, p: np.ndarray) -> bool:
        return bool(np.all(np.abs(p - self.center) <= self.width + 1e-12))

    def _child_index(self, p: np.ndarray) -> int:
        idx = 0
        for i in range(self.d):
            if p[i] > self.center[i]:
                idx |= (1 << i)
        return idx

    def _make_child(self, idx: int) -> "SpTree":
        half = self.width / 2
        offset = np.array([(half[i] if (idx >> i) & 1 else -half[i])
                           for i in range(self.d)])
        return SpTree(self.center + offset, half)

    def insert(self, p: np.ndarray) -> bool:
        p = np.asarray(p, np.float64)
        if not self._contains(p):
            return False
        placed = self._place(p)
        if placed:
            # mass updates only after confirmed placement so node masses
            # always match stored points
            self.cum_size += 1
            self.center_of_mass += (p - self.center_of_mass) / self.cum_size
        return placed

    def _place(self, p: np.ndarray) -> bool:
        if self.is_leaf and self.point is None:
            self.point = p
            return True
        if self.is_leaf:
            if np.allclose(self.point, p):
                return True
            self.children = [None] * (1 << self.d)
            old, self.point = self.point, None
            i = self._child_index(old)
            self.children[i] = self._make_child(i)
            assert self.children[i].insert(old), \
                "existing point fell outside all child cells"
        i = self._child_index(p)
        if self.children[i] is None:
            self.children[i] = self._make_child(i)
        return self.children[i].insert(p)

    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Accumulate Barnes-Hut repulsive forces into neg_f; returns the
        node's contribution to the normalization sum_Q."""
        if self.cum_size == 0:
            return 0.0
        diff = point - self.center_of_mass
        d2 = float(diff @ diff)
        if self.is_leaf and self.point is not None and d2 == 0.0:
            return 0.0
        max_width = float(self.width.max()) * 2
        if self.is_leaf or max_width * max_width < theta * theta * d2:
            q = 1.0 / (1.0 + d2)
            mult = self.cum_size * q
            neg_f += mult * q * diff
            return mult
        return sum(c.compute_non_edge_forces(point, theta, neg_f)
                   for c in self.children if c is not None)

    @staticmethod
    def compute_edge_forces(data: np.ndarray, rows: np.ndarray,
                            cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Attractive forces from sparse CSR-format P (reference
        `SpTree.computeEdgeForces`)."""
        data = np.asarray(data, np.float64)
        pos_f = np.zeros_like(data)
        for i in range(len(data)):
            for k in range(rows[i], rows[i + 1]):
                j = cols[k]
                diff = data[i] - data[j]
                q = vals[k] / (1.0 + diff @ diff)
                pos_f[i] += q * diff
        return pos_f
