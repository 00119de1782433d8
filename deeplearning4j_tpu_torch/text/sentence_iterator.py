"""Sentence / document iterators.

Parity: reference `text/sentenceiterator/*` — file/line/collection iterators
with optional preprocessor and label-aware variants (used by ParagraphVectors
and the supervised vectorizers), and `text/documentiterator/DocumentIterator`.
All expose the same tiny contract: `next_sentence()`, `has_next()`,
`reset()`, plus Python iteration.

A copy of `deeplearning4j_tpu/text/sentence_iterator.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence


class BaseSentenceIterator:
    def __init__(self, preprocessor: Optional[Callable[[str], str]] = None):
        self.preprocessor = preprocessor

    def _prep(self, s: str) -> str:
        return self.preprocessor(s) if self.preprocessor else s

    # -- java-style contract ----------------------------------------------
    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    # -- pythonic iteration ------------------------------------------------
    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(BaseSentenceIterator):
    """In-memory list of sentences (`CollectionSentenceIterator.java`)."""

    def __init__(self, sentences: Sequence[str], preprocessor=None):
        super().__init__(preprocessor)
        self._sentences = list(sentences)
        self._i = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._i]
        self._i += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._i < len(self._sentences)

    def reset(self) -> None:
        self._i = 0


class LineSentenceIterator(BaseSentenceIterator):
    """One sentence per line of a file (`LineSentenceIterator.java`)."""

    def __init__(self, path: str, preprocessor=None):
        super().__init__(preprocessor)
        self.path = os.fspath(path)
        self._f = None
        self._next: Optional[str] = None
        self.reset()

    def _advance(self) -> None:
        line = self._f.readline()
        self._next = line.rstrip("\n") if line else None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._prep(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        if self._f:
            self._f.close()
        self._f = open(self.path, "r", encoding="utf-8", errors="replace")
        self._advance()


class FileSentenceIterator(BaseSentenceIterator):
    """Every file under a directory, one sentence per line
    (`FileSentenceIterator.java`)."""

    def __init__(self, root: str, preprocessor=None):
        super().__init__(preprocessor)
        self.root = os.fspath(root)
        self.reset()

    def _files(self) -> List[str]:
        if os.path.isfile(self.root):
            return [self.root]
        out = []
        for d, _, files in sorted(os.walk(self.root)):
            out.extend(os.path.join(d, f) for f in sorted(files))
        return out

    def reset(self) -> None:
        self._queue: List[str] = []
        for path in self._files():
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                self._queue.extend(line.rstrip("\n") for line in f
                                   if line.strip())
        self._i = 0

    def next_sentence(self) -> str:
        s = self._queue[self._i]
        self._i += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._i < len(self._queue)


class LabelAwareSentenceIterator(CollectionSentenceIterator):
    """(sentence, label) pairs; `current_label()` follows the cursor
    (`LabelAwareListSentenceIterator.java`)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str],
                 preprocessor=None):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        super().__init__(sentences, preprocessor)
        self.labels = list(labels)

    def current_label(self) -> str:
        return self.labels[max(0, self._i - 1)]


class IndexSentenceIterator(BaseSentenceIterator):
    """Sentences streamed from an inverted-index corpus store — the
    `LuceneSentenceIterator.java` analog: the reference iterates the
    sentences Lucene has on disk; here the store is `InvertedIndex` or
    the disk-backed `DiskInvertedIndex` (bounded-RAM streaming), with
    documents detokenized by `sep`."""

    def __init__(self, index, preprocessor=None, sep: str = " "):
        super().__init__(preprocessor)
        self.index = index
        self.sep = sep
        self.reset()

    def reset(self) -> None:
        self._it = iter(self.index.all_docs())
        self._next = next(self._it, None)

    def has_next(self) -> bool:
        return self._next is not None

    def next_sentence(self) -> str:
        toks = self._next
        self._next = next(self._it, None)
        return self._prep(self.sep.join(toks))


class DocumentIterator:
    """Whole-document iterator (`DocumentIterator.java`): each item is the
    full text of one file under root."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        self.reset()

    def reset(self) -> None:
        if os.path.isfile(self.root):
            self._paths = [self.root]
        else:
            self._paths = []
            for d, _, files in sorted(os.walk(self.root)):
                self._paths.extend(os.path.join(d, f) for f in sorted(files))
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._paths)

    def next_document(self) -> str:
        path = self._paths[self._i]
        self._i += 1
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()

    def current_path(self) -> str:
        """Path of the most recently returned document (cursor-following,
        like the label-aware iterators' current_label)."""
        return self._paths[max(0, self._i - 1)]

    def paths(self) -> List[str]:
        """The discovered document paths (recursive sorted walk), for
        consumers that stream file contents themselves."""
        return list(self._paths)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()
