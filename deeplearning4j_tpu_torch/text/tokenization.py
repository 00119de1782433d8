"""Tokenizers.

Parity: reference `text/tokenization/*` — `DefaultTokenizer` (Java
StringTokenizer on whitespace), `DefaultStreamTokenizer`,
`TokenizerFactory` with a pluggable `TokenPreProcess`, N-gram support, and
`InputHomogenization` (lowercase, strip punctuation/diacritics,
`InputHomogenization.java`).

A copy of `deeplearning4j_tpu/text/tokenization.py`: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, List, Optional

_PUNCT = re.compile(r"[\"'\(\)\[\]\{\}<>.,;:!?~`@#$%^&*\-+=/\\|_]")


def input_homogenization(s: str, preserve_case: bool = False) -> str:
    """Lowercase, strip punctuation + diacritics (InputHomogenization.java)."""
    s = unicodedata.normalize("NFKD", s)
    s = "".join(c for c in s if not unicodedata.combining(c))
    s = _PUNCT.sub("", s)
    return s if preserve_case else s.lower()


class DefaultTokenizer:
    """Whitespace tokenizer with optional per-token preprocessor
    (`DefaultTokenizer.java`)."""

    def __init__(self, text: str,
                 preprocessor: Optional[Callable[[str], str]] = None):
        self._tokens = [t for t in text.split() if t]
        self._pre = preprocessor
        self._i = 0

    def count_tokens(self) -> int:
        return len(self._tokens)

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return self._pre(t) if self._pre else t

    def get_tokens(self) -> List[str]:
        out = list(self._tokens[self._i:])
        self._i = len(self._tokens)
        return [self._pre(t) for t in out] if self._pre else out


class NGramTokenizer(DefaultTokenizer):
    """Emits all n-grams from min_n..max_n joined by spaces
    (`NGramTokenizerFactory.java` capability)."""

    def __init__(self, text: str, min_n: int = 1, max_n: int = 2,
                 preprocessor=None):
        super().__init__(text, preprocessor)
        unigrams = super().get_tokens()
        grams: List[str] = []
        for n in range(min_n, max_n + 1):
            for i in range(len(unigrams) - n + 1):
                grams.append(" ".join(unigrams[i:i + n]))
        self._tokens = grams
        self._pre = None
        self._i = 0


class DefaultTokenizerFactory:
    """`TokenizerFactory` contract: create(text) -> Tokenizer, with a
    factory-level TokenPreProcess applied to every token."""

    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self.preprocessor)

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).get_tokens()


class NGramTokenizerFactory(DefaultTokenizerFactory):
    def __init__(self, min_n: int = 1, max_n: int = 2, preprocessor=None):
        super().__init__(preprocessor)
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> NGramTokenizer:
        return NGramTokenizer(text, self.min_n, self.max_n,
                              self.preprocessor)
