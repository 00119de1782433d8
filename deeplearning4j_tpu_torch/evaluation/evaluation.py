"""Evaluation and ConfusionMatrix: classifier metrics on the host.

Counterpart of `deeplearning4j_tpu/evaluation/evaluation.py` (its own
copy): `eval(real, guesses)` accumulates a confusion matrix from one-hot or
probability rows; precision, recall, accuracy and F1 follow from it in exact
integer counts. `evaluate(net, data, batch_size)` runs `net.output` batch
by batch; only the forward pass runs on the device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


class ConfusionMatrix:
    def __init__(self, classes: Optional[List[int]] = None):
        self._m: Dict[int, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
        self.classes = set(classes or [])

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self._m[actual][predicted] += count
        self.classes.add(actual)
        self.classes.add(predicted)

    def count(self, actual: int, predicted: int) -> int:
        return self._m[actual][predicted]

    def actual_total(self, actual: int) -> int:
        return sum(self._m[actual].values())

    def predicted_total(self, predicted: int) -> int:
        return sum(row[predicted] for row in self._m.values())

    def total(self) -> int:
        return sum(self.actual_total(a) for a in list(self.classes))

    def to_array(self) -> np.ndarray:
        classes = sorted(self.classes)
        arr = np.zeros((len(classes), len(classes)), np.int64)
        for i, a in enumerate(classes):
            for j, p in enumerate(classes):
                arr[i, j] = self.count(a, p)
        return arr

    def __str__(self) -> str:
        classes = sorted(self.classes)
        lines = ["actual\\pred " + " ".join(f"{c:>6}" for c in classes)]
        for a in classes:
            lines.append(f"{a:>11} " + " ".join(f"{self.count(a, p):>6}" for p in classes))
        return "\n".join(lines)


class Evaluation:
    def __init__(self):
        self.confusion = ConfusionMatrix()
        self.true_positives: Dict[int, int] = defaultdict(int)
        self.false_positives: Dict[int, int] = defaultdict(int)
        self.false_negatives: Dict[int, int] = defaultdict(int)

    def add(self, actual: int, predicted: int) -> None:
        """Accumulate one (actual, predicted) pair — the primitive both
        `eval()` and tree-level counters (RNTNEval) go through, so every
        metric stays consistent with the confusion matrix."""
        a, p = int(actual), int(predicted)
        self.confusion.add(a, p)
        if a == p:
            self.true_positives[a] += 1
        else:
            self.false_positives[p] += 1
            self.false_negatives[a] += 1

    def eval(self, real_outcomes, guesses) -> None:
        """Accumulate from one-hot / probability matrices (Evaluation.eval)."""
        actual = np.argmax(np.asarray(real_outcomes), axis=-1)
        pred = np.argmax(np.asarray(guesses), axis=-1)
        for a, p in zip(actual.ravel(), pred.ravel()):
            self.add(a, p)

    # -- metrics -----------------------------------------------------------
    def accuracy(self) -> float:
        total = self.confusion.total()
        if not total:
            return 0.0
        correct = sum(self.true_positives.values())
        return correct / total

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fp = self.true_positives[cls], self.false_positives[cls]
            return tp / (tp + fp) if tp + fp else 0.0
        classes = sorted(self.confusion.classes)
        return float(np.mean([self.precision(c) for c in classes])) if classes else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            tp, fn = self.true_positives[cls], self.false_negatives[cls]
            return tp / (tp + fn) if tp + fn else 0.0
        classes = sorted(self.confusion.classes)
        return float(np.mean([self.recall(c) for c in classes])) if classes else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if p + r else 0.0

    def stats(self) -> str:
        lines = [
            f"Examples: {self.confusion.total()}",
            f"Accuracy: {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall: {self.recall():.4f}",
            f"F1: {self.f1():.4f}",
            str(self.confusion),
        ]
        return "\n".join(lines)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def evaluate(net, data, batch_size: int = 0, prefetch: bool = True,
             evaluation: Optional[Evaluation] = None) -> Evaluation:
    """Evaluate `net` batch by batch instead of in one device call.

    `data` is a `DataSet`, a `DataSetIterator`, or any iterable of batches
    with `.features` and `.labels`; a `DataSet` with `0 < batch_size <
    num_examples` is cut into `batch_size`-example batches (with their label
    rows, see `datasets.dataset`). With `prefetch=True` the batches reach
    `net.device` through `datasets.iterator.PrefetchIterator`, each copy
    overlapping the previous batch's forward. Counting is exact integer
    math, so the result does not depend on the batching. With `evaluation`
    the counts accumulate into that `Evaluation`, which is returned."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator, PrefetchIterator)

    if hasattr(data, "features") and hasattr(data, "labels") and \
            not hasattr(data, "__next__"):
        batches = (ListDataSetIterator(data, batch_size)
                   if 0 < batch_size < data.num_examples() else [data])
    else:
        batches = data
    if prefetch:
        batches = PrefetchIterator(batches, device=net.device)
    ev = evaluation if evaluation is not None else Evaluation()
    for batch in batches:
        ev.eval(_host(batch.labels), _host(net.output(batch.features)))
    return ev
