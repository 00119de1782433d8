"""Quad-tree over 2-d points with center-of-mass aggregation.

Parity: reference `clustering/quadtree/QuadTree.java` (396 LoC — boundary
`Cell`, subdivide into NW/NE/SW/SE, center-of-mass per node, cumulative
size; used by 2-d Barnes-Hut t-SNE force approximation).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

QT_NODE_CAPACITY = 1  # reference QuadTree holds one point per leaf


class Cell:
    """Axis-aligned box: center (x, y) and half-widths (hw, hh)."""

    __slots__ = ("x", "y", "hw", "hh")

    def __init__(self, x: float, y: float, hw: float, hh: float):
        self.x, self.y, self.hw, self.hh = x, y, hw, hh

    def contains(self, px: float, py: float) -> bool:
        return (self.x - self.hw <= px <= self.x + self.hw and
                self.y - self.hh <= py <= self.y + self.hh)


class QuadTree:
    def __init__(self, boundary: Cell):
        self.boundary = boundary
        self.center_of_mass = np.zeros(2)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.nw: Optional[QuadTree] = None
        self.ne: Optional[QuadTree] = None
        self.sw: Optional[QuadTree] = None
        self.se: Optional[QuadTree] = None

    @staticmethod
    def build(data: np.ndarray) -> "QuadTree":
        data = np.asarray(data, np.float64)
        mean = data.mean(axis=0)
        half = np.maximum(np.abs(data - mean).max(axis=0), 1e-5) + 1e-5
        tree = QuadTree(Cell(mean[0], mean[1], half[0], half[1]))
        for p in data:
            tree.insert(p)
        return tree

    @property
    def is_leaf(self) -> bool:
        return self.nw is None

    def insert(self, p: np.ndarray) -> bool:
        p = np.asarray(p, np.float64)
        if not self.boundary.contains(p[0], p[1]):
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
                return True  # duplicate point collapses into this leaf
            self._subdivide()
            old, self.point = self.point, None
            moved = any(child.insert(old)
                        for child in (self.nw, self.ne, self.sw, self.se))
            assert moved, "existing point fell outside all child cells"
        return any(child.insert(p)
                   for child in (self.nw, self.ne, self.sw, self.se))

    def _subdivide(self) -> None:
        b = self.boundary
        hw, hh = b.hw / 2, b.hh / 2
        self.nw = QuadTree(Cell(b.x - hw, b.y + hh, hw, hh))
        self.ne = QuadTree(Cell(b.x + hw, b.y + hh, hw, hh))
        self.sw = QuadTree(Cell(b.x - hw, b.y - hh, hw, hh))
        self.se = QuadTree(Cell(b.x + hw, b.y - hh, hw, hh))

    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Barnes-Hut repulsive force accumulation; returns sum_Q share."""
        if self.cum_size == 0:
            return 0.0
        diff = point - self.center_of_mass
        d2 = float(diff @ diff)
        if self.is_leaf and self.point is not None and d2 == 0.0:
            return 0.0  # the query point itself
        max_width = max(self.boundary.hw, self.boundary.hh) * 2
        if self.is_leaf or max_width * max_width < theta * theta * d2:
            q = 1.0 / (1.0 + d2)
            mult = self.cum_size * q
            neg_f += mult * q * diff
            return mult
        return sum(c.compute_non_edge_forces(point, theta, neg_f)
                   for c in (self.nw, self.ne, self.sw, self.se))
