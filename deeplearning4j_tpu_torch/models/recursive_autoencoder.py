"""Recursive autoencoder over binary trees (Socher RAE).

Counterpart of `deeplearning4j_tpu/models/recursive_autoencoder.py`
(reference `nn/layers/feedforward/autoencoder/recursive/
RecursiveAutoEncoder.java`: encode child pairs bottom-up, reconstruct
them, minimise the reconstruction error). It runs on the RNTN's tree
machinery (`models/rntn.py`): the plans, the leaf gather through
`gather_rows` (the scatter-add kernel in its backward), `TreeScan` over the
plan steps with the encode-and-reconstruct cell, and the AdaGrad step as
one cached program a (B, max_nodes, vocab size) key. Internal nodes encode
[left; right] -> d; the loss is each tree's reconstruction error summed
over its valid internal nodes and divided by their count, averaged over
trees, plus l2 on We and Wd, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.rntn import (TreeNode, _TreeModel,
                                                  parse_tree, plan_tree,
                                                  stack_plans, tree_scan)
from deeplearning4j_tpu_torch.nd import random as nd_random


def init_rae_params(key, vocab_size: int, dim: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's initial params, bitwise: `key` split in three for
    E, We and Wd, each `jax.random.uniform` in +-1/sqrt(dim); drawn on the
    key's device and moved to `device` (the key's when None)."""
    ke, kw, kd = nd_random.split(key, 3)
    r = 1.0 / np.sqrt(dim)
    params = {
        "E": nd_random.uniform_dtype(ke, (vocab_size, dim), dtype, -r, r),
        "We": nd_random.uniform_dtype(kw, (2 * dim, dim), dtype, -r, r),
        "be": torch.zeros((dim,), dtype=dtype, device=key.device),
        "Wd": nd_random.uniform_dtype(kd, (dim, 2 * dim), dtype, -r, r),
        "bd": torch.zeros((2 * dim,), dtype=dtype, device=key.device),
    }
    return {k: p.to(device or key.device) for k, p in params.items()}


def _rae_cell(params, a, b):
    """(encoding tanh([a;b]We + be), its reconstruction error
    |tanh(enc Wd + bd) - [a;b]|^2), a batch of rows at once; params (We,
    be, Wd, bd)."""
    we, be, wd, bd = params
    ab = torch.cat([a, b], dim=-1)
    enc = torch.tanh(ab @ we + be)
    rec = torch.tanh(enc @ wd + bd)
    return enc, torch.sum((rec - ab) ** 2, dim=-1)


def _encode_nodes(params, plans):
    """(node vectors [B, N, d], per-node reconstruction errors [B, N])."""
    return tree_scan(_rae_cell, (params["We"], params["be"], params["Wd"],
                                 params["bd"]), params["E"], plans)


def rae_loss(params, plans, l2: float = 1e-4) -> torch.Tensor:
    """Mean per-internal-node reconstruction error over stacked plans."""
    _, err = _encode_nodes(params, plans)
    internal = (~plans["is_leaf"] & plans["valid"]).to(err.dtype)
    per_tree = (torch.sum(err * internal, dim=1)
                / torch.clamp_min(torch.sum(internal, dim=1), 1.0))
    return torch.mean(per_tree) + l2 * (torch.sum(params["We"] ** 2)
                                        + torch.sum(params["Wd"] ** 2))


class RecursiveAutoEncoder(_TreeModel):
    """Greedy tree RAE trained with AdaGrad, mirroring the RNTN trainer, on
    `device` (CUDA unless the caller passes "cpu")."""

    kind = "rae"

    def __init__(self, dim: int = 16, max_nodes: int = 64, lr: float = 0.05,
                 l2: float = 1e-4, seed: int = 0, device=None):
        super().__init__(dim, max_nodes, lr, l2, seed, device)

    def _init_params(self):
        return init_rae_params(nd_random.prng_key(self.seed),
                               len(self.vocab), self.dim, device=self.device)

    def _loss_fn(self):
        return rae_loss

    def fit(self, trees: Sequence["str | TreeNode"], epochs: int = 50
            ) -> float:
        return super().fit(trees, epochs)

    def encode(self, tree: "str | TreeNode") -> np.ndarray:
        """Root embedding of a tree (the learned phrase representation)."""
        t = parse_tree(tree) if isinstance(tree, str) else tree
        plan_obj = plan_tree(t, self.vocab, self.max_nodes)
        with torch.no_grad():
            nodes, _ = _encode_nodes(self.params,
                                     stack_plans([plan_obj], self.device))
        return nodes[0, plan_obj.n_nodes - 1].cpu().numpy()

    def reconstruction_error(self, tree: "str | TreeNode") -> float:
        t = parse_tree(tree) if isinstance(tree, str) else tree
        plans = stack_plans([plan_tree(t, self.vocab, self.max_nodes)],
                            self.device)
        with torch.no_grad():
            return float(rae_loss(self.params, plans, l2=0.0))
