"""Moving-window featurization.

Parity: reference `text/movingwindow/{Windows,WindowConverter,WordConverter,
ContextLabelRetriever}` — fixed-size word windows with <s>/</s> padding,
converted to stacked word-vector features for window-classification models
(the viterbi-decoded sequence labelers), and `util/MovingWindowMatrix`.

A copy of `deeplearning4j_tpu/text/windows.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

BEGIN = "<s>"
END = "</s>"

_BEGIN_LABEL = re.compile(r"^<([A-Za-z0-9_]+)>$")
_END_LABEL = re.compile(r"^</([A-Za-z0-9_]+)>$")
# a tag FRAGMENT embedded in a longer token (`<PER>john`) means the
# markup wasn't whitespace-delimited — silently treating it as text
# would leak tag characters into the training tokens
_EMBEDDED_TAG = re.compile(r"</?[A-Za-z0-9_]+>")


def string_with_labels(sentence: str, tokenizer_factory=None
                       ) -> Tuple[str, List[Tuple[str, List[str]]]]:
    """`ContextLabelRetriever.stringWithLabels` parity: parse inline
    `<LABEL> tokens </LABEL>` markup into (stripped sentence, list of
    (label, tokens) spans); unlabeled runs carry the label "NONE".
    Raises ValueError on unbalanced or mismatched label tags.

    The markup is matched on raw whitespace tokens BEFORE the factory's
    tokenizer runs, so a punctuation-stripping preprocessor (e.g.
    `input_homogenization`, which would erase the <>/ tag characters and
    silently leak 'per john per' into the text) cannot corrupt the
    parse; only the span contents go through the tokenizer."""
    if tokenizer_factory is None:
        from deeplearning4j_tpu_torch.text.tokenization import (
            DefaultTokenizerFactory)

        tokenizer_factory = DefaultTokenizerFactory()
    def tokenize(run: List[str]) -> List[str]:
        return tokenizer_factory.create(" ".join(run)).get_tokens()

    spans: List[Tuple[str, List[str]]] = []
    curr: List[str] = []
    curr_label = None

    def close_run(label: str) -> None:
        toks = tokenize(curr)
        if toks:
            spans.append((label, toks))
        curr.clear()

    for token in sentence.split():
        begin = _BEGIN_LABEL.match(token)
        end = _END_LABEL.match(token)
        if begin:
            if curr_label is not None:
                raise ValueError(
                    f"nested begin label {token!r} inside {curr_label!r}")
            close_run("NONE")  # unlabeled run before this label
            curr_label = begin.group(1)
        elif end:
            if curr_label is None:
                raise ValueError(f"end label {token!r} with no begin label")
            if end.group(1) != curr_label:
                raise ValueError(f"label mismatch: <{curr_label}> ended "
                                 f"by {token!r}")
            close_run(curr_label)
            curr_label = None
        else:
            if _EMBEDDED_TAG.search(token):
                raise ValueError(
                    f"label markup must be whitespace-delimited; found "
                    f"embedded tag in token {token!r}")
            curr.append(token)
    if curr_label is not None:
        raise ValueError(f"unclosed label <{curr_label}>")
    close_run("NONE")
    stripped = " ".join(t for _, toks in spans for t in toks)
    return stripped, spans


class Window:
    def __init__(self, words: Sequence[str], focus: int, label: str = "NONE"):
        self.words = list(words)
        self.focus = focus
        self.label = label

    def focus_word(self) -> str:
        return self.words[self.focus]

    def __repr__(self):
        return f"Window({self.words}, focus={self.focus_word()!r})"


def windows(tokens: Sequence[str], window_size: int = 5) -> List[Window]:
    """All windows over a token list, padded at the edges
    (`Windows.java` contract; window_size must be odd-centered)."""
    half = window_size // 2
    padded = [BEGIN] * half + list(tokens) + [END] * half
    out = []
    for i in range(len(tokens)):
        out.append(Window(padded[i:i + window_size], half))
    return out


def window_features(window: Window, lookup, vec_len: int) -> np.ndarray:
    """Stack word vectors of a window into one feature row
    (`WindowConverter.asExampleMatrix` parity); unknown words -> zeros."""
    rows = []
    for w in window.words:
        v = lookup(w)
        rows.append(np.zeros(vec_len, np.float32) if v is None
                    else np.asarray(v, np.float32))
    return np.concatenate(rows)


def moving_window_matrix(x: np.ndarray, window: int, stride: int = 1
                         ) -> np.ndarray:
    """Rolling windows over a 1-d/2-d array's rows
    (`util/MovingWindowMatrix.java`)."""
    x = np.asarray(x)
    n = (len(x) - window) // stride + 1
    return np.stack([x[i * stride:i * stride + window] for i in range(n)])
