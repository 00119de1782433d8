"""Parameter averaging / aggregation.

Counterpart of `deeplearning4j_tpu/parallel/averaging.py`: the reference's
`INDArrayAggregator` (running sum, then divide by the count),
`BaseLayer.merge` (`a += (b - a) / n`) and Spark's fold-and-divide, over
parameter trees of tensors. Across ranks the same operation is the
all-reduce inside the data-parallel step (`parallel/data_parallel.py`);
these helpers cover host-side aggregation, as the coordinator's runners
use it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from deeplearning4j_tpu_torch.optimize.tree import tree_map


def average_pytrees(trees: Sequence):
    """Element-wise mean over a list of trees of one structure."""
    if not trees:
        raise ValueError("no pytrees to average")
    n = float(len(trees))
    return tree_map(lambda *xs: sum(xs) / n, *trees)


def merge(a, b, n: int):
    """Running merge `a += (b - a) / n` (the reference's `BaseLayer.merge`),
    as a new tree."""
    return tree_map(lambda x, y: x + (y - x) / float(n), a, b)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class ParameterAggregator:
    """Streaming aggregator (the reference's `INDArrayAggregator`):
    `accumulate` worker results one at a time in f32, `aggregate()` returns
    their average."""

    def __init__(self):
        self._sum = None
        self._count = 0

    def accumulate(self, tree) -> None:
        if self._sum is None:
            self._sum = tree_map(_f32, tree)
        else:
            self._sum = tree_map(lambda s, x: s + _f32(x), self._sum, tree)
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def aggregate(self):
        if self._sum is None:
            return None
        n = float(self._count)
        return tree_map(lambda s: s / n, self._sum)

    def reset(self) -> None:
        self._sum, self._count = None, 0
