"""Cluster model classes.

Parity: reference `clustering/cluster/` (`Point`, `Cluster`, `ClusterSet`,
`ClusterInfo`/`ClusterSetInfo` stats) — the data model returned by the
clustering algorithms.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Point:
    """A labeled point (`clustering/cluster/Point.java` contract)."""

    id: str
    array: np.ndarray
    label: Optional[str] = None

    @staticmethod
    def to_points(matrix: np.ndarray) -> List["Point"]:
        return [Point(id=str(i), array=np.asarray(row))
                for i, row in enumerate(np.asarray(matrix))]


@dataclass
class Cluster:
    """A center plus its member points."""

    id: int
    center: np.ndarray
    points: List[Point] = field(default_factory=list)

    def distance_to_center(self, point: Point) -> float:
        return float(np.linalg.norm(point.array - self.center))


@dataclass
class ClusterSet:
    """The result of a clustering run: clusters + point→cluster map and
    distance statistics (`ClusterSetInfo` parity)."""

    clusters: List[Cluster]
    assignments: Dict[str, int] = field(default_factory=dict)

    @property
    def centers(self) -> np.ndarray:
        return np.stack([c.center for c in self.clusters])

    def nearest_cluster(self, array: np.ndarray) -> Cluster:
        d = np.linalg.norm(self.centers - array[None, :], axis=1)
        return self.clusters[int(np.argmin(d))]

    def average_point_distance_to_center(self) -> float:
        total, n = 0.0, 0
        for c in self.clusters:
            for p in c.points:
                total += c.distance_to_center(p)
                n += 1
        return total / max(n, 1)
