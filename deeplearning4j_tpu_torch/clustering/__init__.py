"""Clustering & spatial geometry toolkit.

The port of `deeplearning4j_tpu/clustering/` (reference `clustering/` —
`KMeansClustering` on the `BaseClusteringAlgorithm` strategy framework,
cluster model classes, and the spatial trees `kdtree/KDTree.java`,
`vptree/VPTree.java`, `quadtree/QuadTree.java`, `sptree/SpTree.java` that
back Barnes-Hut t-SNE and nearest-neighbour queries).

k-means' distances, assignment and center updates run on the device (one
matrix product for the distances); the trees are host-side index
structures over numpy arrays, copies of the JAX package's (pointer-chasing
recursion has nothing to gain on a card).
"""

from deeplearning4j_tpu_torch.clustering.cluster import (Cluster, ClusterSet,
                                                          Point)
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.strategy import (
    BaseClusteringAlgorithm, ClusteringOptimizationType,
    ConvergenceCondition, FixedClusterCountStrategy,
    FixedIterationCountCondition, IterationHistory, OptimisationStrategy,
    VarianceVariationCondition)

__all__ = [
    "Cluster", "ClusterSet", "Point", "KMeansClustering", "KDTree",
    "VPTree", "QuadTree", "SpTree", "BaseClusteringAlgorithm",
    "ClusteringOptimizationType", "ConvergenceCondition",
    "FixedClusterCountStrategy", "FixedIterationCountCondition",
    "IterationHistory", "OptimisationStrategy",
    "VarianceVariationCondition",
]
