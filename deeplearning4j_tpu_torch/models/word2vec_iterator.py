"""Word2Vec-featurized moving-window DataSet iterator.

Parity: reference `models/word2vec/iterator/Word2VecDataSetIterator.java`
(+ `Word2VecDataFetcher.java`) — stream a label-aware sentence iterator,
cut every sentence into moving word windows (`Windows.windows`), featurize
each window by concatenating the pretrained word2vec vectors of its words
(`WindowConverter.asExampleMatrix`), and batch (features, one-hot window
label) pairs into DataSets for window-classification models (the
Viterbi-decoded sequence labelers).

A copy of `deeplearning4j_tpu/models/word2vec_iterator.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.text.windows import (Window, string_with_labels,
                                             window_features, windows)

log = logging.getLogger(__name__)


def _windows_to_dataset(take, vec, n_labels: int, label_index) -> DataSet:
    """Featurize labeled windows: concatenated w2v vectors + one-hot
    labels (shared by the iterator and the fetcher).  Raises ValueError
    for a window label outside the label set."""
    feats = np.stack([
        window_features(w, vec.vector, vec.vector_length) for w in take])
    y = np.zeros((len(take), n_labels), np.float32)
    for i, w in enumerate(take):
        idx = label_index.get(w.label)
        if idx is None:
            raise ValueError(
                f"window label {w.label!r} not in labels "
                f"{sorted(label_index)}")
        y[i, idx] = 1.0
    return DataSet(feats, y)


class Word2VecDataSetIterator:
    """Batches of word-window examples featurized by a trained Word2Vec.

    `sentence_iter` follows the label-aware contract
    (`next_sentence()`/`has_next()`/`reset()` + `current_label()`); plain
    iterators work too when every window should carry `default_label` —
    include it in `labels` in that case.  A window label outside
    `labels` raises ValueError (the reference would index at -1).
    """

    def __init__(self, vec, sentence_iter, labels: Sequence[str],
                 batch: int = 10, window: Optional[int] = None,
                 default_label: str = "NONE"):
        self.vec = vec
        self.iter = sentence_iter
        self.labels = list(labels)
        self.batch = batch
        self.window = window or getattr(vec, "window", 5)
        self.default_label = default_label
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        self._cache: List[Window] = []

    # -- java-style contract ----------------------------------------------
    def input_columns(self) -> int:
        return self.window * self.vec.vector_length

    def total_outcomes(self) -> int:
        return len(self.labels)

    def reset(self) -> None:
        self.iter.reset()
        self._cache.clear()

    def has_next(self) -> bool:
        # a remaining sentence may tokenize to nothing, so pull until a
        # real window exists — has_next() True guarantees next() != None
        self._fill(1)
        return bool(self._cache)

    def _fill(self, num: int) -> None:
        while len(self._cache) < num and self.iter.has_next():
            sentence = self.iter.next_sentence()
            if not sentence.strip():
                continue
            label = (self.iter.current_label()
                     if hasattr(self.iter, "current_label")
                     else self.default_label)
            toks = (self.vec.tokenize(sentence)
                    if hasattr(self.vec, "tokenize") else sentence.split())
            for w in windows(toks, self.window):
                w.label = label
                self._cache.append(w)

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        num = num or self.batch
        self._fill(num)
        if not self._cache:
            return None
        take, self._cache = self._cache[:num], self._cache[num:]
        return _windows_to_dataset(take, self.vec, len(self.labels),
                                   self._label_index)

    def __iter__(self):
        self.reset()
        while self.has_next():
            ds = self.next()
            if ds is None:
                return
            yield ds


class Word2VecDataFetcher:
    """`Word2VecDataFetcher.java` parity: walk text files under `path`
    whose sentences carry inline `<LABEL> ... </LABEL>` span markup
    (ContextLabelRetriever format), cut every span into word windows
    featurized by the trained w2v vectors, and serve them as one DataSet
    with one-hot span labels.  Unlabeled runs carry "NONE" — include it
    in `labels` if such runs should train."""

    def __init__(self, vec, path: str, labels: Sequence[str],
                 window: Optional[int] = None):
        import os

        self.vec = vec
        self.path = os.fspath(path)
        self.labels = list(labels)
        self.window = window or getattr(vec, "window", 5)
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        self.cursor = 0
        self._windows: List[Window] = []
        self._load()

    def _load(self) -> None:
        from deeplearning4j_tpu_torch.text.sentence_iterator import (
            DocumentIterator)
        from deeplearning4j_tpu_torch.text.tokenization import (
            DefaultTokenizerFactory)

        factory = DefaultTokenizerFactory()
        # DocumentIterator supplies the recursive sorted walk; file
        # contents are read line-by-line (no whole-file strings), though
        # the RESULT — every labeled window of the corpus — is held in
        # RAM like the reference fetcher; stream from DiskInvertedIndex
        # for corpora beyond memory
        for fp in DocumentIterator(self.path).paths():
            with open(fp, "r", encoding="utf-8", errors="replace") as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        _, spans = string_with_labels(line.strip(), factory)
                    except ValueError as e:
                        # a non-corpus file (README, HTML) swept up by the
                        # directory walk must not abort the whole load
                        log.warning("skipping malformed line in %s: %s",
                                    fp, e)
                        continue
                    for label, toks in spans:
                        if (label != "NONE"
                                and label not in self._label_index):
                            raise ValueError(
                                f"markup label {label!r} in {fp} not in "
                                f"labels {self.labels}")
                        if label not in self._label_index:
                            continue  # NONE runs with no NONE class
                        for w in windows(toks, self.window):
                            w.label = label
                            self._windows.append(w)

    # -- DataSetFetcher contract ------------------------------------------
    def total_examples(self) -> int:
        return len(self._windows)

    def input_columns(self) -> int:
        return self.window * self.vec.vector_length

    def total_outcomes(self) -> int:
        return len(self.labels)

    def reset(self) -> None:
        self.cursor = 0

    def has_more(self) -> bool:
        return self.cursor < len(self._windows)

    def fetch(self, num_examples: int) -> Optional[DataSet]:
        if num_examples <= 0:
            raise ValueError(f"num_examples must be positive, "
                             f"got {num_examples}")
        take = self._windows[self.cursor:self.cursor + num_examples]
        if not take:
            return None
        self.cursor += len(take)
        return _windows_to_dataset(take, self.vec, len(self.labels),
                                   self._label_index)
