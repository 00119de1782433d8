"""Part-of-speech tagging + PoS-filtered tokenization.

Capability parity with reference `text/tokenization/tokenizer/
PosUimaTokenizer.java` (+ the UIMA annotators under `text/annotator/`):
tokenize and keep only tokens whose part of speech is in an allow-list.
The reference ships ClearTK/OpenNLP UIMA models; hermetic equivalent here
is a lexicon + suffix-rule tagger over Penn-style coarse tags — same
filtering contract, no external models.

A copy of `deeplearning4j_tpu/text/pos.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence

# coarse Penn-style tagset
DET = {"the", "a", "an", "this", "that", "these", "those"}
PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
        "us", "them", "my", "your", "his", "its", "our", "their"}
PREP = {"in", "on", "at", "by", "for", "with", "about", "against", "between",
        "into", "through", "during", "before", "after", "above", "below",
        "to", "from", "up", "down", "of", "off", "over", "under"}
CONJ = {"and", "but", "or", "nor", "so", "yet", "because", "although",
        "while", "if", "unless"}
AUX = {"is", "am", "are", "was", "were", "be", "been", "being", "have",
       "has", "had", "do", "does", "did", "will", "would", "shall",
       "should", "may", "might", "must", "can", "could"}

_NUM_RE = re.compile(r"^[+-]?\d+([.,]\d+)*$")


class PosTagger:
    """Lexicon + suffix-rule tagger: tag(tokens) -> coarse Penn tags."""

    def tag_word(self, tok: str, prev_tag: Optional[str] = None) -> str:
        w = tok.lower()
        if _NUM_RE.match(w):
            return "CD"
        if w in DET:
            return "DT"
        if w in PRON:
            return "PRP"
        if w in PREP:
            return "IN"
        if w in CONJ:
            return "CC"
        if w in AUX:
            return "MD" if w in {"will", "would", "shall", "should", "may",
                                 "might", "must", "can", "could"} else "VB"
        if w.endswith("ly"):
            return "RB"
        if w.endswith(("ing",)):
            return "VBG"
        if w.endswith(("ed",)):
            return "VBD"
        if w.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
            return "JJ"
        if w.endswith(("tion", "ment", "ness", "ity", "ance", "ence")):
            return "NN"
        if w.endswith("s") and len(w) > 3 and not w.endswith("ss"):
            return "NNS"
        if tok[:1].isupper() and prev_tag is not None:
            return "NNP"
        # determiner/adjective context suggests a noun; default noun
        return "NN"

    def tag(self, tokens: Sequence[str]) -> List[str]:
        tags: List[str] = []
        for tok in tokens:
            tags.append(self.tag_word(tok, tags[-1] if tags else None))
        return tags


def default_tagger(device=None):
    """The trained bigram-HMM tagger bundled in-package (hmm_pos.py) —
    context-sensitive, the analog of the reference's trained UIMA models;
    falls back to the rule lexicon if the bundled artifact is absent. Its
    Viterbi decode runs on `device` (CUDA unless the caller passes
    "cpu")."""
    try:
        from deeplearning4j_tpu_torch.text.hmm_pos import bundled_tagger

        return bundled_tagger(device=device)
    except (OSError, ValueError, KeyError):
        return PosTagger()


class PosFilterTokenizerFactory:
    """TokenizerFactory wrapper keeping only allowed parts of speech
    (`PosUimaTokenizer` contract: non-matching tokens are dropped)."""

    def __init__(self, base_factory, allowed_tags: Iterable[str],
                 tagger=None, device=None):
        self.base = base_factory
        self.allowed = set(allowed_tags)
        self.tagger = tagger or default_tagger(device)

    def tokenize(self, text: str) -> List[str]:
        toks = self.base.create(text).get_tokens()
        tags = self.tagger.tag(toks)
        return [t for t, g in zip(toks, tags) if g in self.allowed]

    def create(self, text: str):
        from deeplearning4j_tpu_torch.text.tokenization import \
            DefaultTokenizer

        filtered = " ".join(self.tokenize(text))
        return DefaultTokenizer(filtered)
