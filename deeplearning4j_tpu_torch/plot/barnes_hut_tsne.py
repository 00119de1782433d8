"""Barnes-Hut t-SNE (theta-approximate, O(n log n)).

Parity: reference `plot/BarnesHutTsne.java:62-704` — sparse input
affinities via VPTree k-NN + per-point perplexity search
(`computeGaussianPerplexity` :109), SpTree edge/non-edge force
accumulation (:239+), gains+momentum updates, early exaggeration.

Host-side by design: tree traversal is irreducibly pointer-chasing. The
dense math (perplexity search over the kNN distance matrix) still runs as
a vectorized numpy program; for n where dense is feasible prefer
`plot.tsne.Tsne`, which keeps everything on the device. A copy of the
JAX package's module over the port's trees.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

MACHINE_EPSILON = 1e-12


class BarnesHutTsne:
    """`BarnesHutTsne` Builder-parity knobs; theta controls approximation
    (theta=0 → exact forces)."""

    def __init__(self, max_iter: int = 1000, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iter: int = 250, stop_lying_iter: int = 250,
                 exaggeration: float = 12.0, min_gain: float = 0.01,
                 n_components: int = 2, seed: int = 0):
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iter = switch_momentum_iter
        self.stop_lying_iter = stop_lying_iter
        self.exaggeration = exaggeration
        self.min_gain = min_gain
        self.n_components = n_components
        self.seed = seed
        self.y: Optional[np.ndarray] = None

    def compute_gaussian_perplexity(self, x: np.ndarray):
        """Sparse symmetrized P over 3*perplexity nearest neighbors
        (reference :109-237). Returns CSR (rows, cols, vals)."""
        x = np.asarray(x, np.float64)
        n = len(x)
        k = min(int(3 * self.perplexity), n - 1)
        tree = VPTree(x, seed=self.seed)
        log_u = np.log(self.perplexity)

        cols = np.zeros((n, k), np.int64)
        vals = np.zeros((n, k))
        for i in range(n):
            nbrs = tree.knn(x[i], k + 1)[1:]  # drop self
            d = np.array([dd * dd for dd, _ in nbrs])
            idx = np.array([j for _, j in nbrs])
            beta, bmin, bmax = 1.0, -np.inf, np.inf
            for _ in range(50):
                p = np.exp(-d * beta)
                sum_p = max(p.sum(), MACHINE_EPSILON)
                h = np.log(sum_p) + beta * (d * p).sum() / sum_p
                diff = h - log_u
                if abs(diff) < 1e-5:
                    break
                if diff > 0:
                    bmin = beta
                    beta = beta * 2.0 if np.isinf(bmax) else (beta + bmax) / 2
                else:
                    bmax = beta
                    beta = beta / 2.0 if np.isinf(bmin) else (beta + bmin) / 2
            p = np.exp(-d * beta)
            cols[i], vals[i] = idx, p / max(p.sum(), MACHINE_EPSILON)

        # symmetrize the sparse matrix: P = (P + P^T) / (2n)
        dense: dict = {}
        for i in range(n):
            for j_pos in range(k):
                j = int(cols[i, j_pos])
                v = vals[i, j_pos]
                dense[(i, j)] = dense.get((i, j), 0.0) + v
                dense[(j, i)] = dense.get((j, i), 0.0) + v
        total = sum(dense.values())
        items = sorted(dense.items())
        rows = np.zeros(n + 1, np.int64)
        out_cols = np.zeros(len(items), np.int64)
        out_vals = np.zeros(len(items))
        for p_idx, ((i, j), v) in enumerate(items):
            rows[i + 1] += 1
            out_cols[p_idx] = j
            out_vals[p_idx] = v / total
        rows = np.cumsum(rows)
        return rows, out_cols, out_vals

    def gradient(self, y: np.ndarray, rows, cols, vals) -> np.ndarray:
        """BH-approximate KL gradient via SpTree forces."""
        tree = SpTree.build(y)
        pos_f = SpTree.compute_edge_forces(y, rows, cols, vals)
        neg_f = np.zeros_like(y)
        sum_q = 0.0
        for i in range(len(y)):
            f = np.zeros(self.n_components)
            sum_q += tree.compute_non_edge_forces(y[i], self.theta, f)
            neg_f[i] = f
        return pos_f - neg_f / max(sum_q, MACHINE_EPSILON)

    def calculate(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = len(x)
        rows, cols, vals = self.compute_gaussian_perplexity(x)

        rng = np.random.RandomState(self.seed)
        y = rng.randn(n, self.n_components) * 1e-4
        y_incs = np.zeros_like(y)
        gains = np.ones_like(y)

        vals_lied = vals * self.exaggeration
        for it in range(self.max_iter):
            v = vals_lied if it < self.stop_lying_iter else vals
            mom = (self.momentum if it < self.switch_momentum_iter
                   else self.final_momentum)
            grad = self.gradient(y, rows, cols, v)
            sign_match = np.sign(grad) == np.sign(y_incs)
            gains = np.clip(np.where(sign_match, gains * 0.8, gains + 0.2),
                            self.min_gain, None)
            y_incs = mom * y_incs - self.learning_rate * gains * grad
            y = y + y_incs
            y = y - y.mean(axis=0)
        self.y = y
        return y

    # Model-contract conveniences (reference BarnesHutTsne implements Model)
    def fit(self, x: np.ndarray) -> None:
        self.calculate(x)

    def params(self) -> np.ndarray:
        return self.y
