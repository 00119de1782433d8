"""DataSet: a (features, labels) pair of host numpy arrays.

Counterpart of `deeplearning4j_tpu/datasets/dataset.py` (its own copy: the
port imports nothing of the JAX package): counting, row selection and
batching, a seeded shuffle, merging, binarizing, a seeded test/train split
and a seeded sample, and the two feature scalings the CLI offers.

One deliberate difference: labels may hold k rows per example, window
after window, as a sequence model's next-step targets do ([B*T, V] for
features [B, T, V], the text: scheme's layout). Selecting examples then
selects their k label rows. The JAX package slices those labels by example
index, so its batches pair windows with the wrong targets (ROADMAP.md
queue C).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

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

    def __iter__(self):
        for i in range(self.num_examples()):
            yield self.get(slice(i, i + 1))

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

    def copy(self) -> "DataSet":
        return DataSet(self.features.copy(), self.labels.copy())

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """The examples of every dataset, in order (label rows follow their
        examples, as each set holds them)."""
        return DataSet(
            np.concatenate([d.features for d in datasets], axis=0),
            np.concatenate([d.labels for d in datasets], axis=0),
        )

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self.get(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    def shuffle(self, seed: int = 123) -> "DataSet":
        """The examples in the order of the JAX package's shuffle (a
        `RandomState(seed)` permutation), each with its label rows."""
        idx = np.random.RandomState(seed).permutation(self.num_examples())
        return self.get(idx)

    def split_test_and_train(self, n_train: int, seed: int = 123
                             ) -> Tuple["DataSet", "DataSet"]:
        """(the first n_train examples, the rest) of the seeded shuffle."""
        shuffled = self.shuffle(seed)
        return (shuffled.get(slice(0, n_train)),
                shuffled.get(slice(n_train, None)))

    def sample(self, n: int, seed: int = 123) -> "DataSet":
        """n examples drawn by `RandomState(seed).choice`, as the JAX
        package draws them (with replacement when n exceeds the examples),
        each with its label rows."""
        rng = np.random.RandomState(seed)
        idx = rng.choice(self.num_examples(), size=n,
                         replace=n > self.num_examples())
        return self.get(idx)

    def normalize_zero_mean_unit_variance(self) -> "DataSet":
        mean = self.features.mean(axis=0, keepdims=True)
        std = self.features.std(axis=0, keepdims=True) + 1e-6
        return DataSet((self.features - mean) / std, self.labels)

    def scale_to_unit(self) -> "DataSet":
        mx = np.abs(self.features).max() or 1.0
        return DataSet(self.features / mx, self.labels)

    def binarize(self, threshold: float = 0.0) -> "DataSet":
        return DataSet((self.features > threshold).astype(np.float32),
                       self.labels)


def labels_to_one_hot(labels: Iterable[int], n_classes: int) -> np.ndarray:
    labels = np.asarray(list(labels), np.int64)
    out = np.zeros((len(labels), n_classes), np.float32)
    out[np.arange(len(labels)), labels] = 1.0
    return out
