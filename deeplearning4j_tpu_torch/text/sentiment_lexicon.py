"""Sentiment lexicon — SentiWordNet-reader parity.

The reference bundles a SentiWordNet corpus reader
(`text/corpora/sentiwordnet/SWN3.java`: loads the scored synset TSV,
aggregates per-word pos/neg strengths) whose scores label tree nodes for
RNTN sentiment training.  Same contract here, with the reference's actual
aggregation (SWN3.java:64-126): entries are keyed `word#POS`, each synset
score (PosScore - NegScore) lands at its 1-based sense rank, and the
per-key score is the harmonically-weighted mean over sense ranks
(sum_i v[i]/(i+1)  /  sum_{i=1..n} 1/i) — first senses dominate.
`score(word)` is `SWN3.extract` parity: the sum across the four POS keys
(n/a/r/v).  `score_tokens` is `SWN3.scoreTokens` parity: the sentence
score is the sum of per-token extracts, with the polarity FLIPPED when
any negation word (SWN3.java:52 negationWords) occurs in the sentence.

A real scored lexicon ships in-package (`data/sentiment_lexicon.tsv`,
352 graded entries in the SWN3 layout, gloss column omitted — the way
`data/pos_model.json` bundles the trained tagger) and loads by default,
so scored lookups are available hermetically; a tiny built-in dict is the
last-resort fallback.

A copy of `deeplearning4j_tpu/text/sentiment_lexicon.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

_BUNDLED = os.path.join(os.path.dirname(__file__), "data",
                        "sentiment_lexicon.tsv")

_BUILTIN = {
    "good": 0.75, "great": 0.88, "excellent": 1.0, "nice": 0.6,
    "happy": 0.8, "love": 0.9, "wonderful": 0.9, "best": 0.9,
    "fine": 0.4, "amazing": 0.9, "fantastic": 0.9, "positive": 0.6,
    "bad": -0.65, "awful": -0.9, "terrible": -0.9, "poor": -0.6,
    "sad": -0.7, "hate": -0.9, "worst": -1.0, "horrible": -0.9,
    "negative": -0.6, "wrong": -0.5, "ugly": -0.7, "boring": -0.6,
}

# SWN3.java:52 — a sentence containing any of these flips its polarity
NEGATION_WORDS = frozenset({
    "could", "would", "should", "not", "isn't", "aren't", "wasn't",
    "weren't", "haven't", "doesn't", "didn't", "don't",
})

_POS_TAGS = ("n", "a", "r", "v")  # the four keys extract() sums over


class SentimentLexicon:
    def __init__(self, scores: Optional[Dict[str, float]] = None):
        # pos_scores: `word#pos` -> harmonically-aggregated score (the
        # SWN3 _dict); scores: word -> extract() sum across POS keys.
        self.pos_scores: Dict[str, float] = {}
        if scores is not None:
            self.scores = dict(scores)
        elif os.path.exists(_BUNDLED):
            self.pos_scores = self._parse_swn(_BUNDLED)
            self.scores = self._extract_all(self.pos_scores)
        else:
            self.scores = dict(_BUILTIN)

    @staticmethod
    def _parse_swn(path: str) -> Dict[str, float]:
        """SWN3.java:64-126 aggregation: key `word#POS`; synset scores
        (Pos-Neg) indexed by sense rank; per-key score = sense-rank
        harmonic weighting  sum_i v[i]/(i+1) / sum_{i=1..n} 1/i.
        Comment lines start with '#'; a trailing gloss column (standard
        SentiWordNet 3.x has 6 columns) is ignored if present."""
        by_key: Dict[str, List[float]] = {}
        with open(path) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 5 or not parts[2] or not parts[3]:
                    continue
                try:
                    score = float(parts[2]) - float(parts[3])
                except ValueError:
                    continue
                pos = parts[0].strip().lower()
                for term in parts[4].split():
                    word, _, rank_s = term.rpartition("#")
                    if not word:
                        word, rank_s = term, "1"
                    try:
                        rank = int(rank_s)
                    except ValueError:
                        word, rank = term, 1
                    if rank < 1:  # malformed sense rank: skip like the
                        continue  # other unparseable fields
                    key = f"{word.lower()}#{pos}"
                    v = by_key.setdefault(key, [])
                    if len(v) < rank:
                        v.extend([0.0] * (rank - len(v)))
                    v[rank - 1] = score
        out: Dict[str, float] = {}
        for key, v in by_key.items():
            num = sum(x / (i + 1) for i, x in enumerate(v))
            den = sum(1.0 / i for i in range(1, len(v) + 1))
            out[key] = num / den if den else 0.0
        return out

    @staticmethod
    def _extract_all(pos_scores: Dict[str, float]) -> Dict[str, float]:
        """Word-level view: SWN3.extract sums the word's n/a/r/v keys."""
        words = {k.rsplit("#", 1)[0] for k in pos_scores}
        return {w: sum(pos_scores.get(f"{w}#{p}", 0.0) for p in _POS_TAGS)
                for w in words}

    @classmethod
    def from_sentiwordnet(cls, path: str) -> "SentimentLexicon":
        lex = cls(scores={})
        lex.pos_scores = cls._parse_swn(path)
        lex.scores = cls._extract_all(lex.pos_scores)
        return lex

    def score(self, word: str) -> float:
        """`SWN3.extract` parity: summed polarity across POS entries;
        0 for unknown words."""
        return self.scores.get(word.lower(), 0.0)

    def score_tokens(self, tokens) -> float:
        """`SWN3.scoreTokens` parity: sum of per-token extracts, with the
        aggregate FLIPPED when any negation word occurs in the span."""
        total = 0.0
        negated = False
        for tok in tokens:
            total += self.score(tok)
            if tok.lower() in NEGATION_WORDS:
                negated = True
        return -total if negated else total

    @staticmethod
    def class_for_score(score: float) -> str:
        """`SWN3.classForScore` graded sentiment names.  The reference's
        band predicates overlap/contradict (e.g. `score>0 && score>=0.25`
        after the 0.25..0.5 branch leaves (0, 0.25) neutral); here the
        bands are rationalized into contiguous monotone ranges with the
        same seven names."""
        if score >= 0.75:
            return "strong_positive"
        if score >= 0.25:
            return "positive"
        if score > 0:
            return "weak_positive"
        if score <= -0.75:
            return "strong_negative"
        if score <= -0.25:
            return "negative"
        if score < 0:
            return "weak_negative"
        return "neutral"

    @staticmethod
    def label_for_score(s: float, n_classes: int = 2,
                        neutral: Optional[int] = None) -> int:
        """Class label for a polarity score: binary {neg=0, pos=1} or
        {neg=0, neutral=1, pos=2} for n_classes=3.  In binary mode a
        sentiment-free score (|s| == 0) maps to `neutral` when given —
        callers that can skip supervision pass their neutral sentinel so
        function-word leaves don't all become hard negatives.  The
        sentinel applies in every mode, so an explicit neutral_label
        (e.g. -1 = unsupervised) is honored for n_classes=3 too."""
        if s == 0 and neutral is not None:
            return neutral
        if n_classes == 2:
            return 1 if s > 0 else 0
        if s > 0.1:
            return 2
        if s < -0.1:
            return 0
        return 1

    def label(self, word: str, n_classes: int = 2) -> int:
        return self.label_for_score(self.score(word), n_classes)

    def label_fn(self, n_classes: int = 2):
        """`label_fn` for TreeParser."""
        return lambda tok: self.label(tok, n_classes)
