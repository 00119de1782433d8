"""Exact t-SNE on the device.

The port of `deeplearning4j_tpu/plot/tsne.py` (reference
`plot/Tsne.java:49-530` — `hBeta` + per-point perplexity binary search
(:109-170), symmetrized P, then the gains+momentum gradient loop
(:271-330) with early exaggeration).

The perplexity search runs over all rows at once with a fixed 50 halvings
(the reference's maxTries), and every gradient iteration is a few tensor
ops over dense (n, n) matrices on the device, the affinities through one
matrix product, term for term the JAX package's. The initial embedding is
the JAX package's `normal(PRNGKey(seed), (n, n_components)) * 1e-4`
(`nd/random.normal_dtype`, within 3 ulps of JAX's draw).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.nd.ops import pairwise_sq_dists
from deeplearning4j_tpu_torch.nd.platform import resolve_device

MACHINE_EPSILON = 1e-12


def _sq_dists(x: torch.Tensor) -> torch.Tensor:
    return pairwise_sq_dists(x, x)


def _h_beta(d: torch.Tensor, beta: torch.Tensor):
    """Entropy H [n] and probabilities [n, n] of each row of d at its
    precision beta [n], the diagonal left out (`Tsne.hBeta` parity)."""
    p = torch.exp(-d * beta[:, None])
    p.fill_diagonal_(0.0)
    sum_p = torch.clamp_min(torch.sum(p, dim=1), MACHINE_EPSILON)
    h = torch.log(sum_p) + beta * torch.sum(d * p, dim=1) / sum_p
    return h, p / sum_p[:, None]


def binary_search_probs(d: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Per-row binary search for the beta whose entropy is log(perplexity),
    all rows at once; 50 tries (reference :129 maxTries=50)."""
    n = d.shape[0]
    log_u = torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                   device=d.device))
    beta = torch.ones(n, dtype=torch.float32, device=d.device)
    bmin = torch.full_like(beta, -np.inf)
    bmax = torch.full_like(beta, np.inf)
    for _ in range(50):
        h, _ = _h_beta(d, beta)
        up = h - log_u > 0
        bmin = torch.where(up, beta, bmin)
        bmax = torch.where(up, bmax, beta)
        beta = torch.where(
            up,
            torch.where(torch.isinf(bmax), beta * 2.0, (beta + bmax) / 2.0),
            torch.where(torch.isinf(bmin), beta / 2.0, (beta + bmin) / 2.0))
    _, p = _h_beta(d, beta)
    return p


def tsne_grad(y: torch.Tensor, p: torch.Tensor):
    """KL gradient wrt the embedding under the Student-t kernel, and the
    KL divergence (a 0-d tensor)."""
    num = 1.0 / (1.0 + _sq_dists(y))
    num.fill_diagonal_(0.0)
    q = torch.clamp_min(num / torch.sum(num), MACHINE_EPSILON)
    pq = (p - q) * num
    grad = 4.0 * ((torch.diag(torch.sum(pq, dim=1)) - pq) @ y)
    kl = torch.sum(p * torch.log(torch.clamp_min(p, MACHINE_EPSILON) / q))
    return grad, kl


def tsne_update(y, grad, y_incs, gains, momentum, learning_rate, min_gain):
    """Gains + momentum update (`Tsne.java:284-305` semantics)."""
    sign_match = torch.sign(grad) == torch.sign(y_incs)
    gains = torch.clamp_min(torch.where(sign_match, gains * 0.8, gains + 0.2),
                            min_gain)
    y_incs = momentum * y_incs - learning_rate * gains * grad
    y = y + y_incs
    y = y - torch.mean(y, dim=0)  # re-center (reference :316)
    return y, y_incs, gains


class Tsne:
    """Exact t-SNE. Builder-parity knobs from `Tsne.java` Builder; runs on
    `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, max_iter: int = 1000, perplexity: float = 30.0,
                 learning_rate: float = 500.0, momentum: float = 0.5,
                 final_momentum: float = 0.8, switch_momentum_iter: int = 250,
                 stop_lying_iter: int = 250, exaggeration: float = 12.0,
                 min_gain: float = 0.01, n_components: int = 2,
                 seed: int = 0, device=None):
        self.max_iter = max_iter
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iter = switch_momentum_iter
        self.stop_lying_iter = stop_lying_iter
        self.exaggeration = exaggeration
        self.min_gain = min_gain
        self.n_components = n_components
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_history: list = []

    def compute_p(self, x) -> torch.Tensor:
        """Symmetrized input affinities P (reference
        `computeGaussianPerplexity`), [n, n] on the device."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        p = binary_search_probs(_sq_dists(x), self.perplexity)
        p = p + p.T
        return torch.clamp_min(p / torch.sum(p), MACHINE_EPSILON)

    def initial_y(self, n: int) -> torch.Tensor:
        """The JAX package's start: normal(PRNGKey(seed), (n, c)) * 1e-4."""
        key = nd_random.prng_key(self.seed, device=self.device)
        return nd_random.normal_dtype(key, (n, self.n_components)) * 1e-4

    def calculate(self, x) -> np.ndarray:
        """Embed (n, d) → (n, n_components)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        p = self.compute_p(x)
        y = self.initial_y(n)
        y_incs = torch.zeros_like(y)
        gains = torch.ones_like(y)
        self.kl_history = []

        p_lied = p * self.exaggeration
        for it in range(self.max_iter):
            p_cur = p_lied if it < self.stop_lying_iter else p
            mom = (self.momentum if it < self.switch_momentum_iter
                   else self.final_momentum)
            grad, _ = tsne_grad(y, p_cur)
            y, y_incs, gains = tsne_update(
                y, grad, y_incs, gains, mom, self.learning_rate,
                self.min_gain)
            if it % 100 == 0:
                # log KL against the true (un-exaggerated) P so entries are
                # comparable across the lying/plain phases
                _, kl = tsne_grad(y, p)
                self.kl_history.append(float(kl))
        return y.cpu().numpy()
