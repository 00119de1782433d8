"""Word2Vec — skip-gram with hierarchical softmax + negative sampling.

The port of `deeplearning4j_tpu/models/word2vec.py` (reference
`models/word2vec/Word2Vec.java` with the inner math of
`InMemoryLookupTable.iterateSample`). The objective is the JAX package's
batched one, term for term: skip-gram pairs built on the host with the
dynamic window shrink and subsampling from the same numpy stream,
hierarchical softmax over padded [B, L] Huffman code/point arrays gathered
from syn1, negatives drawn from the unigram table, the summed loss, and
SGD (linear alpha decay) or per-word AdaGrad.

Gradients come from autograd, as the JAX package's come from `jax.grad`.
Every table is read through `gather_rows`, whose backward is the
scatter-add kernel (`csrc/scatter_add.cu`) on the card: a step launches it
once for syn0, once for syn1 and, with negatives, once for syn1neg (the
context and negative rows in one gather). The tables are updated in place.

Randomness: the pairs and the batch order come from `RandomState(seed)`
exactly as in JAX; the negatives from `draw_negative_slots` with a
`torch.Generator` seeded with `seed`, where JAX draws from threefry keys
(the tests replay JAX's draws through that function).

Per epoch `fit` uploads the pairs, their weights and the batch order once
(the vocab-side arrays once per call) and steps on device slices, with no
copy from the host per step.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.models.embeddings import InMemoryLookupTable
from deeplearning4j_tpu_torch.nd.kernels import gather_rows
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.text.corpus import TokenCorpus
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import Huffman, VocabCache

log = logging.getLogger("deeplearning4j_tpu_torch")

SYN_KEYS = ("syn0", "syn1", "syn1neg")


def add_adagrad_state(tables: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Attach zeroed per-word AdaGrad accumulators ``h_*`` beside each
    lookup table (shared by Word2Vec and ParagraphVectors)."""
    for k in SYN_KEYS:
        tables["h_" + k] = torch.zeros_like(tables[k])
    return tables


def draw_negative_slots(generator: torch.Generator, batch: int,
                        negative: int, table_len: int,
                        device: torch.device) -> torch.Tensor:
    """`negative` uniform slots of the unigram table for each of `batch`
    pairs, [batch, negative] int64 on `device`, from `generator` (a
    generator of that device)."""
    return torch.randint(0, table_len, (batch, negative),
                         generator=generator, device=device)


def w2v_loss(syn0, syn1, syn1neg, centers, contexts, codes, points,
             code_mask, neg=None, weights=None) -> torch.Tensor:
    """The summed skip-gram loss of one batch (the `loss_fn` of the JAX
    package's `_w2v_step_impl`): hierarchical softmax over the context
    word's Huffman path and, when `neg` ([B, K] word ids) is given, the
    logistic loss of the context against K negatives, each negative that
    equals the context left out. `weights` [B] scales each pair (0 for
    padding); None means all ones. Tables are read through `gather_rows`."""
    v_in = gather_rows(syn0, centers)                          # [B, D]
    w = (torch.ones(centers.shape[0], device=syn0.device)
         if weights is None else weights)
    nodes = gather_rows(syn1, points)                          # [B, L, D]
    dots = torch.einsum("bd,bld->bl", v_in, nodes)
    sign = 1.0 - 2.0 * codes                                   # code 0 -> +1
    hs = -F.logsigmoid(sign * dots) * code_mask
    total = torch.sum(torch.sum(hs, dim=1) * w)
    if neg is not None:
        no_coll = (neg != contexts[:, None]).to(torch.float32)
        rows = gather_rows(syn1neg, torch.cat([contexts[:, None], neg], 1))
        d = torch.einsum("bd,bkd->bk", v_in, rows)             # [B, 1 + K]
        total = total - torch.sum(F.logsigmoid(d[:, 0]) * w)
        total = total + torch.sum(-F.logsigmoid(-d[:, 1:]) * no_coll
                                  * w[:, None])
    # SUM, not mean: each pair contributes a full-strength update, as the
    # reference's per-sample SGD applies alpha per pair
    return total


def w2v_step(tables: Dict[str, torch.Tensor], centers, contexts, codes,
             points, code_mask, neg, alpha, use_adagrad: bool = False,
             weights=None) -> torch.Tensor:
    """One batched skip-gram step on `tables` (syn0, syn1, syn1neg and,
    with `use_adagrad`, their ``h_*`` accumulators), in place; returns the
    loss before the step. SGD: t -= alpha * g. AdaGrad, per word and
    dimension: h += g^2; t -= alpha * g / sqrt(h + 1e-8). A table the loss
    does not read (syn1neg without negatives) is left as it is: its
    gradient is zero."""
    leaves = [tables[k].detach().requires_grad_() for k in SYN_KEYS]
    loss = w2v_loss(*leaves, centers, contexts, codes, points, code_mask,
                    neg, weights)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        for k, g in zip(SYN_KEYS, grads):
            if g is None:
                continue
            if use_adagrad:
                h = tables["h_" + k]
                h.add_(g * g)
                tables[k].sub_(alpha * g / torch.sqrt(h + 1e-8))
            else:
                tables[k].sub_(alpha * g)
    return loss.detach()


class Word2Vec:
    """Reference-parity configuration surface: vector length, window,
    min word frequency, subsampling, negative sampling, alpha decay; runs
    on `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, sentences=None, tokenizer_factory=None,
                 vector_length: int = 100, window: int = 5,
                 min_word_frequency: int = 5, alpha: float = 0.025,
                 min_alpha: float = 1e-4, negative: int = 5,
                 use_hierarchical_softmax: bool = True,
                 sample: float = 0.0, batch_size: int = 512,
                 epochs: int = 1, seed: int = 123,
                 stop_words=(), use_adagrad: bool = False, device=None):
        self.sentences = sentences
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.alpha = alpha
        self.min_alpha = min_alpha
        self.negative = negative
        self.use_hs = use_hierarchical_softmax
        self.sample = sample
        self.batch_size = batch_size
        self.epochs = epochs
        self.seed = seed
        self.use_adagrad = use_adagrad
        self.stop_words = set(stop_words)
        self.device = resolve_device(device)
        self.cache: Optional[VocabCache] = None
        self.table: Optional[InMemoryLookupTable] = None
        self._rng = np.random.RandomState(seed)

    # -- vocab -------------------------------------------------------------
    def tokenize(self, sentence: str) -> List[str]:
        return [t for t in self.tokenizer.tokenize(sentence)
                if t and t not in self.stop_words]

    def build_vocab(self, token_lists: Sequence[Sequence[str]]) -> None:
        self.cache = VocabCache(self.min_word_frequency).fit(token_lists)
        Huffman.build(self.cache)
        self.table = InMemoryLookupTable(
            self.cache, self.vector_length, self.seed,
            negative=float(self.negative), device=self.device)

    # -- pair generation (host side) --------------------------------------
    def _pairs(self, token_ids: Sequence[np.ndarray]):
        """Skip-gram (center, context) pairs with dynamic window shrink
        (reference `skipGram`: b = rand % window) and frequency
        subsampling, vectorized over the flattened corpus; the same draws
        from the same `RandomState` as the JAX package's `_pairs`."""
        counts = self.cache.counts()
        total = counts.sum()
        flat = np.concatenate([np.asarray(x, np.int64) for x in token_ids]) \
            if token_ids else np.zeros(0, np.int64)
        sent = np.concatenate(
            [np.full(len(x), k, np.int64)
             for k, x in enumerate(token_ids)]) \
            if token_ids else np.zeros(0, np.int64)
        if self.sample > 0 and len(flat):
            # word2vec subsampling: keep with prob (sqrt(f/t)+1)*t/f
            f = counts[flat] / total
            keep = (np.sqrt(f / self.sample) + 1) * self.sample / f
            m = self._rng.rand(len(flat)) < keep
            flat, sent = flat[m], sent[m]
        n = len(flat)
        if n == 0 or self.window < 1:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        # reach = window - b with b = rand % window  ->  uniform in
        # [1, window], one draw per center position
        reach = self._rng.randint(1, self.window + 1, size=n)
        offs = np.concatenate([np.arange(-self.window, 0),
                               np.arange(1, self.window + 1)]).astype(np.int32)
        # chunk the position axis so the [chunk, 2w] grids stay bounded
        cen_parts, ctx_parts = [], []
        chunk = 1 << 20
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            j = np.arange(s, e, dtype=np.int32)[:, None] + offs[None, :]
            valid = (np.abs(offs)[None, :] <= reach[s:e, None]) \
                & (j >= 0) & (j < n)
            j_cl = np.clip(j, 0, n - 1)
            valid &= sent[j_cl] == sent[s:e, None]
            ii = np.broadcast_to(np.arange(s, e, dtype=np.int32)[:, None],
                                 j.shape)
            cen_parts.append(flat[ii[valid]].astype(np.int32))
            ctx_parts.append(flat[j_cl[valid]].astype(np.int32))
        return np.concatenate(cen_parts), np.concatenate(ctx_parts)

    def _vocab_arrays(self):
        """Huffman codes, points and mask [V, L] on the device (the mask
        zeroed when hierarchical softmax is off) and the unigram table."""
        codes, points, mask = Huffman.padded_arrays(self.cache)
        if not self.use_hs:
            mask = np.zeros_like(mask)
        dev = self.device
        return (torch.as_tensor(codes, device=dev),
                torch.as_tensor(points, device=dev),
                torch.as_tensor(mask, device=dev),
                torch.as_tensor(self.table.unigram_table(), device=dev))

    def _batch_step(self, tables, generator, centers, contexts, vocab,
                    alpha, weights=None) -> torch.Tensor:
        """One step on device index tensors: the pairs' Huffman rows, the
        negatives (through `draw_negative_slots`) and `w2v_step`."""
        codes, points, mask, neg_table = vocab
        neg = None
        if self.negative > 0:
            slots = draw_negative_slots(generator, centers.shape[0],
                                        self.negative, neg_table.shape[0],
                                        self.device)
            neg = neg_table[slots]
        return w2v_step(tables, centers, contexts, codes[contexts],
                        points[contexts], mask[contexts], neg, alpha,
                        self.use_adagrad, weights=weights)

    # -- training ----------------------------------------------------------
    def fit(self, sentences=None) -> "Word2Vec":
        sentences = sentences if sentences is not None else self.sentences
        token_lists = TokenCorpus(sentences, self.tokenize)
        if self.cache is None:
            self.build_vocab(token_lists)
        ids_per_sentence = [
            np.asarray([self.cache.index_of(t) for t in toks
                        if t in self.cache], np.int32)
            for toks in token_lists]

        dev = self.device
        vocab = self._vocab_arrays()
        if self.table.syn1neg is None:
            self.table.syn1neg = torch.zeros(self.cache.num_words(),
                                             self.vector_length, device=dev)
        # the table's own tensors, updated in place
        tables = {k: getattr(self.table, k) for k in SYN_KEYS}
        if self.use_adagrad:
            add_adagrad_state(tables)
        generator = torch.Generator(device=dev).manual_seed(self.seed)

        # a fresh pair draw per epoch (Word2Vec.java re-rolls the window
        # shrink and the subsampling coin on every pass); the capacity
        # starts 2 % above epoch 1's count, as in the JAX package
        centers, contexts = self._pairs(ids_per_sentence)
        if len(centers) == 0:
            log.warning("word2vec: no training pairs")
            return self
        B = self.batch_size
        k_steps = (int(len(centers) * 1.02) - 1) // B + 1
        cap = k_steps * B
        steps_total = max(1, self.epochs * k_steps)
        step_i = 0
        for epoch in range(self.epochs):
            if epoch > 0:
                centers, contexts = self._pairs(ids_per_sentence)
            n_pairs = len(centers)
            if n_pairs > cap:  # rare: this draw outgrew the capacity
                k_steps = (n_pairs - 1) // B + 1
                cap = k_steps * B
            # pad to the capacity with weight-0 slots: every real pair is
            # applied exactly once per epoch
            pad = cap - n_pairs
            centers_dev = torch.as_tensor(np.pad(centers, (0, pad)),
                                          device=dev)
            contexts_dev = torch.as_tensor(np.pad(contexts, (0, pad)),
                                           device=dev)
            weights_dev = torch.as_tensor(
                (np.arange(cap) < n_pairs).astype(np.float32), device=dev)
            batch_idx = torch.as_tensor(
                self._rng.permutation(cap).reshape(k_steps, B), device=dev)
            if self.use_adagrad:
                # AdaGrad scales each step by its history; the reference's
                # AdaGrad path keeps the configured lr fixed
                alphas = np.full(k_steps, self.alpha, np.float32)
            else:
                # linear alpha decay (Word2Vec.java alpha schedule)
                alphas = np.maximum(
                    self.min_alpha,
                    self.alpha * (1 - (step_i + np.arange(k_steps))
                                  / steps_total)).astype(np.float32)
            alphas_dev = torch.as_tensor(alphas, device=dev)
            for s in range(k_steps):
                idx = batch_idx[s]
                self._batch_step(tables, generator, centers_dev[idx],
                                 contexts_dev[idx], vocab, alphas_dev[s],
                                 weights=weights_dev[idx])
            step_i += k_steps
        return self

    # -- query surface (delegates to the lookup table) ---------------------
    def vector(self, word):
        return self.table.vector(word)

    def similarity(self, a, b):
        return self.table.similarity(a, b)

    def words_nearest(self, word, top=10):
        return self.table.words_nearest(word, top)

    def analogy(self, a, b, c, top=5):
        return self.table.analogy(a, b, c, top)
