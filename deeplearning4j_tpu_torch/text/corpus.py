"""Multi-pass corpus streaming shared by the embedding trainers.

Word2Vec/GloVe walk their corpus twice (vocab count, then id / co-
occurrence conversion) WITHOUT materializing token text, so a
disk-backed corpus (`DiskInvertedIndex.docs()`) trains at bounded RSS.
The edge cases live here once instead of per-model:

- a one-shot OUTER iterator (generator of sentences) is materialized,
- str sentences are re-tokenized per pass (nothing held),
- list/tuple sentences are cheap to re-list per pass,
- any other inner item (e.g. a one-shot generator of tokens) is
  materialized on first touch and cached, so pass 2 doesn't read a
  drained iterator as an empty sentence.

A copy of `deeplearning4j_tpu/text/corpus.py`: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List


class TokenCorpus:
    """Re-iterable token-list view over a heterogeneous corpus."""

    def __init__(self, sentences, tokenize: Callable[[str], List[str]]):
        if iter(sentences) is iter(sentences):  # one-shot outer iterator
            sentences = list(sentences)
        self._sentences = sentences
        self._tokenize = tokenize
        self._cache: Dict[int, List[str]] = {}

    def __iter__(self) -> Iterator[List[str]]:
        for i, s in enumerate(self._sentences):
            if isinstance(s, str):
                yield self._tokenize(s)
            elif isinstance(s, (list, tuple)):
                yield list(s)
            else:  # one-shot inner iterable: materialize once, reuse
                if i not in self._cache:
                    self._cache[i] = list(s)
                yield self._cache[i]
