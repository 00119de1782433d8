"""DataSet: a (features, labels) pair of host numpy arrays.

Counterpart of `deeplearning4j_tpu/datasets/dataset.py` (its own copy: the
port imports nothing of the JAX package): counting, row selection and
batching, a seeded shuffle, and the two feature scalings the CLI offers.
Merging, binarizing, splitting and sampling are not ported yet.

One deliberate difference: labels may hold k rows per example, window
after window, as a sequence model's next-step targets do ([B*T, V] for
features [B, T, V], the text: scheme's layout). Selecting examples then
selects their k label rows. The JAX package slices those labels by example
index, so its batches pair windows with the wrong targets (ROADMAP.md
queue C).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


class DataSet:
    def __init__(self, features, labels=None):
        self.features = np.asarray(features)
        self.labels = (np.asarray(labels) if labels is not None
                       else np.zeros((len(self.features), 0), np.float32))

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def num_inputs(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def num_outcomes(self) -> int:
        return int(self.labels.shape[-1]) if self.labels.ndim > 1 else 0

    def __len__(self) -> int:
        return self.num_examples()

    def label_rows(self) -> int:
        """Label rows per example: k when the labels hold k > 1 rows for
        each example, else 1."""
        n, m = len(self.features), len(self.labels)
        return m // n if n and m != n and m % n == 0 else 1

    def get(self, idx) -> "DataSet":
        """The examples at `idx` (an index, slice or index array) with their
        label rows."""
        k = self.label_rows()
        if k == 1:
            return DataSet(self.features[idx], self.labels[idx])
        tail = self.labels.shape[1:]
        blocks = self.labels.reshape((len(self.features), k) + tail)[idx]
        return DataSet(self.features[idx], blocks.reshape((-1,) + tail))

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self.get(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    def shuffle(self, seed: int = 123) -> "DataSet":
        """The examples in the order of the JAX package's shuffle (a
        `RandomState(seed)` permutation), each with its label rows."""
        idx = np.random.RandomState(seed).permutation(self.num_examples())
        return self.get(idx)

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        mean = self.features.mean(axis=0, keepdims=True)
        std = self.features.std(axis=0, keepdims=True) + 1e-6
        return DataSet((self.features - mean) / std, self.labels)

    def scale_to_unit(self) -> "DataSet":
        mx = np.abs(self.features).max() or 1.0
        return DataSet(self.features / mx, self.labels)


def labels_to_one_hot(labels: Iterable[int], n_classes: int) -> np.ndarray:
    labels = np.asarray(list(labels), np.int64)
    out = np.zeros((len(labels), n_classes), np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out
