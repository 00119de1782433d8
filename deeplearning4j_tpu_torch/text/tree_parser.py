"""Sentence -> binary parse trees for recursive models (RNTN input).

Capability parity with reference `text/corpora/treeparser/TreeParser.java`
(+ `TreeVectorizer`, `BinarizeTreeTransformer`, head-word finding): the
reference shells out to vendored CRFsuite binaries and UIMA annotators to
chunk sentences into NP/VP constituents, then binarizes the chunk tree
with head rules.  Neither native binary exists here, so the TPU framework
ships hermetic parser strategies with the same output contract (binary
`TreeNode`s consumable by `models/rntn`):

- "right" / "left": right- or left-branching chains (the standard
  baseline for recursive nets without a treebank).
- "balanced": minimum-depth binary tree (better for deep composition).
- "chunk": the linguistic path — tokens are PoS-tagged by the trained
  HMM tagger (`text/hmm_pos.py`), grouped into NP/VP/ADJP/ADVP/PP chunks
  by tag patterns, each chunk binarized around its head word (NP: last
  noun; VP: first verb; ADJP/ADVP: last word — CollinsHeadFinder-style
  rules), and chunk roots folded right-branching into the sentence tree.
  This is the CRFsuite+UIMA `TreeParser.getTrees` analog, trained-model
  chunking included, with zero native binaries.

Labels default to a neutral class; `label_fn(token) -> int` lets callers
attach per-leaf labels.  Passing `lexicon=` (a
`text/sentiment_lexicon.SentimentLexicon`) instead labels EVERY node from
the aggregate lexicon polarity of its span — the role SentiWordNet plays
in the reference's RNTN pipeline, where inner nodes carry phrase-level
sentiment supervision.  Two SWN3 behaviors carry over: a span containing
a negation word has its polarity FLIPPED (SWN3.scoreTokens), and
sentiment-free spans in binary mode are left UNSUPERVISED (label -1,
masked by rntn_loss) rather than silently becoming hard negatives.

The port's copy of `deeplearning4j_tpu/text/tree_parser.py`. One addition:
`device=` names where the chunk strategy's tagger decodes (CUDA unless the
caller passes "cpu"); the other strategies touch no device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.models.rntn import TreeNode
from deeplearning4j_tpu_torch.text.sentiment_lexicon import (
    NEGATION_WORDS as _NEGATION_WORDS)
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory

_NOUN = ("NN", "NNS")
_VERB = ("VB", "VBD", "VBN", "VBP", "VBZ")


def _chunk_spans(tags: Sequence[str]) -> List[Tuple[int, int, int, str]]:
    """Greedy tag-pattern chunking -> (start, end, head_index, type).

    Patterns (Penn tagset subset emitted by hmm_pos):
      NP   = DT? (JJ|CD)* (NN|NNS)+   head = last noun
      PRP  = PRP                      (pronoun NP)
      VP   = MD? RB* VERB+            head = first verb
      ADJP = RB* JJ+                  head = last adjective
      ADVP = RB+                      head = last adverb
      else one-token chunk.
    """
    spans: List[Tuple[int, int, int, str]] = []
    n = len(tags)
    i = 0
    while i < n:
        if tags[i] == "PRP":
            spans.append((i, i + 1, i, "NP"))
            i += 1
            continue
        # NP
        j = i + 1 if tags[i] == "DT" else i
        k = j
        while k < n and tags[k] in ("JJ", "CD"):
            k += 1
        m = k
        while m < n and tags[m] in _NOUN:
            m += 1
        if m > k:
            spans.append((i, m, m - 1, "NP"))
            i = m
            continue
        # VP
        j = i + 1 if tags[i] == "MD" else i
        while j < n and tags[j] == "RB":
            j += 1
        m = j
        while m < n and tags[m] in _VERB:
            m += 1
        if m > j:
            spans.append((i, m, j, "VP"))
            i = m
            continue
        # ADJP / ADVP
        j = i
        while j < n and tags[j] == "RB":
            j += 1
        m = j
        while m < n and tags[m] == "JJ":
            m += 1
        if m > j:
            spans.append((i, m, m - 1, "ADJP"))
            i = m
            continue
        if j > i:
            spans.append((i, j, j - 1, "ADVP"))
            i = j
            continue
        spans.append((i, i + 1, i, tags[i]))
        i += 1
    return spans


class TreeParser:
    def __init__(self, strategy: str = "balanced", n_classes: int = 2,
                 neutral_label: Optional[int] = None,
                 label_fn: Optional[Callable[[str], int]] = None,
                 lexicon=None, tokenizer_factory=None, tagger=None,
                 device=None):
        if strategy not in ("right", "left", "balanced", "chunk"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.n_classes = n_classes
        self.neutral_label = 0 if neutral_label is None else neutral_label
        self.lexicon = lexicon
        # span labeling only when the caller did not supply explicit leaf
        # labels — an explicit label_fn always wins (gold supervision)
        self._span_labeling = lexicon is not None and label_fn is None
        # sentiment-free spans in binary lexicon mode: there is no honest
        # class, so default to -1 = UNSUPERVISED (rntn_loss masks it);
        # an explicit neutral_label overrides
        if neutral_label is not None:
            self._span_neutral = neutral_label
        else:
            self._span_neutral = -1 if n_classes == 2 else 1
        if self._span_labeling:
            # leaves get their final labels in _annotate_spans; neutral here
            label_fn = lambda tok: self.neutral_label  # noqa: E731
        self.label_fn = label_fn or (lambda tok: self.neutral_label)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self._tagger = tagger  # lazily loaded for strategy="chunk"
        self.device = device   # the lazily loaded tagger's

    @property
    def tagger(self):
        if self._tagger is None:
            from deeplearning4j_tpu_torch.text.hmm_pos import bundled_tagger

            self._tagger = bundled_tagger(device=self.device)
        return self._tagger

    # -- leaves
    def _leaf(self, tok: str) -> TreeNode:
        return TreeNode(label=self.label_fn(tok), word=tok)

    def _merge(self, a: TreeNode, b: TreeNode, head: str = "right") -> TreeNode:
        # internal label: propagate the head child's label (the
        # head-word-finding analog; chunk strategy picks real heads)
        return TreeNode(label=(b if head == "right" else a).label,
                        left=a, right=b)

    def _build(self, leaves: List[TreeNode]) -> TreeNode:
        if len(leaves) == 1:
            return leaves[0]
        if self.strategy == "right":
            node = leaves[-1]
            for leaf in reversed(leaves[:-1]):
                node = self._merge(leaf, node)
            return node
        if self.strategy == "left":
            node = leaves[0]
            for leaf in leaves[1:]:
                node = self._merge(node, leaf)
            return node
        mid = len(leaves) // 2
        return self._merge(self._build(leaves[:mid]), self._build(leaves[mid:]))

    def _build_headed(self, leaves: List[TreeNode], head_i: int) -> TreeNode:
        """Binarize a chunk around its head: modifiers fold onto the head
        nearest-first, every internal label inherited from the head."""
        node = leaves[head_i]
        for leaf in reversed(leaves[:head_i]):
            node = self._merge(leaf, node, head="right")
        for leaf in leaves[head_i + 1:]:
            node = self._merge(node, leaf, head="left")
        return node

    def _build_chunked(self, tokens: List[str]) -> TreeNode:
        tags = self.tagger.tag(tokens)
        leaves = [self._leaf(t) for t in tokens]
        chunks: List[Tuple[TreeNode, str]] = []
        for s, e, h, typ in _chunk_spans(tags):
            chunks.append((self._build_headed(leaves[s:e], h - s), typ))
        # PP attachment: a lone preposition absorbs the NP to its right
        # (PP = IN + NP, head = NP — sentiment lives in the object)
        merged: List[Tuple[TreeNode, str]] = []
        for node, typ in chunks:
            if merged and merged[-1][1] in ("IN", "TO") and typ == "NP":
                prep, _ = merged.pop()
                merged.append((self._merge(prep, node, head="right"), "PP"))
            else:
                merged.append((node, typ))
        # sentence level: fold chunk roots right-branching; the rightmost
        # chunk (typically the predicate ADJP/VP) heads the sentence
        node = merged[-1][0]
        for left, _ in reversed(merged[:-1]):
            node = self._merge(left, node, head="right")
        return node

    def _annotate_spans(self, node: TreeNode) -> Tuple[float, bool]:
        """Label every node from its span's aggregate lexicon polarity
        (phrase-level sentiment supervision, the SentiWordNet role).

        Negation (SWN3.scoreTokens parity, generalized span-wise): each
        span's RAW score is the sum of its leaves' extracts; if the span
        contains any negation word the effective score is flipped — a
        presence flag, not parity, so 'not good' is negative at every
        span containing the 'not', exactly once.  Returns (raw score,
        span-contains-negation).

        Sentiment-free spans (raw score 0 — function-word leaves,
        neutral phrases) take `neutral_label` instead of defaulting into
        the binary negative class (the reference's classForScore has an
        explicit neutral)."""
        if node.is_leaf:
            score = self.lexicon.score(node.word)
            negated = node.word.lower() in _NEGATION_WORDS
        else:
            ls, ln = self._annotate_spans(node.left)
            rs, rn = self._annotate_spans(node.right)
            score, negated = ls + rs, ln or rn
        eff = -score if negated else score
        node.label = self.lexicon.label_for_score(
            eff, self.n_classes, neutral=self._span_neutral)
        return score, negated

    # -- public API (TreeParser.getTrees analog)
    def parse(self, sentence: str) -> Optional[TreeNode]:
        tokens = self.tokenizer_factory.create(sentence).get_tokens()
        if not tokens:
            return None
        if self.strategy == "chunk":
            tree = self._build_chunked(tokens)
        else:
            tree = self._build([self._leaf(t) for t in tokens])
        if self._span_labeling:
            self._annotate_spans(tree)
        return tree

    def get_trees(self, sentences: Sequence[str]) -> List[TreeNode]:
        out = []
        for s in sentences:
            t = self.parse(s)
            if t is not None:
                out.append(t)
        return out
