"""Bag-of-words and TF-IDF vectorizers.

Parity: reference `bagofwords/vectorizer/{BagOfWordsVectorizer,
TfidfVectorizer}` — fit over a sentence iterator + tokenizer factory,
transform text to fixed-width vocab-count (or tf-idf weighted) rows, with
optional label -> one-hot DataSet output for text classification.

A copy of `deeplearning4j_tpu/text/vectorizers.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.text.inverted_index import InvertedIndex
from deeplearning4j_tpu_torch.text.stopwords import STOP_WORDS
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache


class BagOfWordsVectorizer:
    """Counts per vocab word (`BagOfWordsVectorizer.java`)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1,
                 stop_words=STOP_WORDS, labels: Sequence[str] = ()):
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.cache = VocabCache(min_word_frequency)
        self.index = InvertedIndex()
        self.stop_words = set(stop_words or ())
        self.labels = list(labels)

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer.tokenize(text)
                if t not in self.stop_words]

    def fit(self, sentences, labels: Optional[Sequence[str]] = None
            ) -> "BagOfWordsVectorizer":
        toks_list = []
        for i, s in enumerate(sentences):
            toks = self._tokens(s)
            toks_list.append(toks)
            self.index.add_doc(toks,
                               labels[i] if labels is not None else None)
        self.cache.fit(toks_list)
        if labels is not None and not self.labels:
            self.labels = sorted(set(labels))
        return self

    def _weight(self, word: str, count: float, n_tokens: int) -> float:
        return count

    def transform(self, text: str) -> np.ndarray:
        toks = self._tokens(text)
        row = np.zeros(self.cache.num_words(), np.float32)
        for t in toks:
            i = self.cache.index_of(t)
            if i >= 0:
                row[i] += 1.0
        for i in np.nonzero(row)[0]:
            row[i] = self._weight(self.cache.word_at_index(int(i)),
                                  float(row[i]), len(toks))
        return row

    def transform_many(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.transform(t) for t in texts])

    def vectorize(self, text: str, label: str) -> DataSet:
        """text+label -> DataSet row (reference `vectorize(String,String)`)."""
        x = self.transform(text)[None]
        y = np.zeros((1, len(self.labels)), np.float32)
        y[0, self.labels.index(label)] = 1.0
        return DataSet(x, y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting (`TfidfVectorizer.java`): tf * log(N / df)."""

    def _weight(self, word: str, count: float, n_tokens: int) -> float:
        tf = count / max(1, n_tokens)
        df = self.index.doc_frequency(word)
        n = self.index.num_documents()
        idf = math.log((n + 1.0) / (df + 1.0)) + 1.0  # smoothed
        return tf * idf
