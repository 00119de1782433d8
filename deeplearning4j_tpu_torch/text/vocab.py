"""Vocabulary cache + Huffman coding for hierarchical softmax.

Parity: reference `models/word2vec/VocabWord`, `text/...` vocab caches
(`InMemoryLookupCache` — word -> VocabWord with Huffman code points) and
`models/word2vec/Huffman.java` (builds codes/points over frequency-sorted
vocab; 131 LoC).

A copy of `deeplearning4j_tpu/text/vocab.py`: the port imports nothing of
the JAX package, and its tables are indexed by the same word order, Huffman
codes and points.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

UNK = "UNK"


@dataclass
class VocabWord:
    word: str
    count: float = 0.0
    index: int = -1
    codes: List[int] = field(default_factory=list)    # Huffman bits
    points: List[int] = field(default_factory=list)   # inner-node indices


class VocabCache:
    """word -> VocabWord, index <-> word maps, frequency accounting
    (`InMemoryLookupCache` contract: addToken/incrementWordCount/wordFor/
    indexOf/wordAtIndex/numWords/totalWordOccurrences)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency
        self.vocab: Dict[str, VocabWord] = {}
        self._index: List[str] = []
        self.total_word_occurrences = 0.0
        self.n_docs = 0

    # -- building ----------------------------------------------------------
    def increment_word_count(self, word: str, by: float = 1.0) -> None:
        vw = self.vocab.get(word)
        if vw is None:
            vw = self.vocab[word] = VocabWord(word=word)
        vw.count += by
        self.total_word_occurrences += by

    def fit(self, sentences_tokens: Iterable[Sequence[str]]) -> "VocabCache":
        """Count tokens, drop words under min_word_frequency, assign indices
        by descending frequency (the order Huffman + the unigram table
        expect)."""
        from collections import Counter

        counts = Counter()
        for tokens in sentences_tokens:
            self.n_docs += 1
            counts.update(tokens)  # C-speed counting, no per-token Python
        for w, c in counts.items():
            self.increment_word_count(w, c)
        self.vocab = {w: vw for w, vw in self.vocab.items()
                      if vw.count >= self.min_word_frequency}
        self._index = sorted(self.vocab,
                             key=lambda w: (-self.vocab[w].count, w))
        for i, w in enumerate(self._index):
            self.vocab[w].index = i
        return self

    # -- lookups -----------------------------------------------------------
    def word_for(self, word: str) -> Optional[VocabWord]:
        return self.vocab.get(word)

    def index_of(self, word: str) -> int:
        vw = self.vocab.get(word)
        return vw.index if vw else -1

    def word_at_index(self, i: int) -> str:
        return self._index[i]

    def num_words(self) -> int:
        return len(self._index)

    def words(self) -> List[str]:
        return list(self._index)

    def counts(self) -> np.ndarray:
        return np.asarray([self.vocab[w].count for w in self._index],
                          np.float64)

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def __len__(self) -> int:
        return len(self._index)


class Huffman:
    """Build Huffman codes/points over a frequency-sorted vocab
    (`Huffman.java` parity; word2vec-style arrays).

    After `build(cache)`, every VocabWord has `codes` (bits, root->leaf)
    and `points` (inner-node ids on the path, root->leaf), with inner node
    ids in [0, num_words-1) — usable directly as rows of syn1.
    """

    @staticmethod
    def build(cache: VocabCache) -> VocabCache:
        n = cache.num_words()
        if n == 0:
            return cache
        counts = cache.counts()
        # heap of (count, tiebreak, node_id); leaves 0..n-1, inner n..2n-2
        heap = [(counts[i], i, i) for i in range(n)]
        heapq.heapify(heap)
        parent = np.zeros(2 * n - 1, np.int64)
        binary = np.zeros(2 * n - 1, np.int8)
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a] = next_id
            parent[b] = next_id
            binary[b] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = 2 * n - 2
        for i in range(n):
            codes: List[int] = []
            points: List[int] = []
            node = i
            while node != root:
                codes.append(int(binary[node]))
                points.append(int(parent[node]) - n)  # inner-node row id
                node = int(parent[node])
            codes.reverse()
            points.reverse()
            vw = cache.word_for(cache.word_at_index(i))
            vw.codes = codes
            vw.points = points
        return cache

    @staticmethod
    def padded_arrays(cache: VocabCache):
        """Dense [V, L] codes/points/mask arrays for on-device hierarchical
        softmax (the TPU-native form of the per-word Java lists)."""
        n = cache.num_words()
        L = max((len(cache.word_for(w).codes) for w in cache.words()),
                default=0)
        codes = np.zeros((n, L), np.float32)
        points = np.zeros((n, L), np.int32)
        mask = np.zeros((n, L), np.float32)
        for i, w in enumerate(cache.words()):
            vw = cache.word_for(w)
            k = len(vw.codes)
            codes[i, :k] = vw.codes
            points[i, :k] = vw.points
            mask[i, :k] = 1.0
        return codes, points, mask
