"""ParagraphVectors (doc2vec) — document embeddings on the word2vec machinery.

The port of `deeplearning4j_tpu/models/paragraph_vectors.py` (reference
`ParagraphVectors.java`, `extends Word2Vec`). The word tables are trained
by plain word2vec first; then each document's vector, in syn0's slot of
`w2v_step`, predicts every word of the document through the HS tree and the
negatives (PV-DBOW), while copies of syn1 and syn1neg co-train and the word
tables stay as the word phase left them. Every gather's backward is the
scatter-add kernel on the card, as in Word2Vec.

The doc table starts as U(-0.5, 0.5) / D from a generator seeded with
seed + 1 (the JAX package draws it from threefry), or from the array passed
to `fit` (e.g. the JAX package's, carried across).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.embeddings import uniform_init
from deeplearning4j_tpu_torch.models.word2vec import (Word2Vec,
                                                      add_adagrad_state)


class ParagraphVectors(Word2Vec):
    def __init__(self, *args, labels: Optional[Sequence[str]] = None,
                 doc_epochs: Optional[int] = None, **kw):
        super().__init__(*args, **kw)
        self.labels: List[str] = list(labels) if labels else []
        self.doc_vectors: Optional[torch.Tensor] = None
        # doc vectors see far fewer pairs than words do (one per token vs
        # one per window slot), so the doc phase runs longer by default
        self.doc_epochs = doc_epochs if doc_epochs else 5 * self.epochs

    def fit(self, sentences=None, labels=None,
            doc_vectors=None) -> "ParagraphVectors":
        """Train the word tables, then the doc vectors. `doc_vectors`, if
        given, is the starting doc table [n_docs, vector_length] (numpy)."""
        sentences = list(sentences if sentences is not None
                         else self.sentences)
        if labels is not None:
            self.labels = list(labels)
        if not self.labels:
            self.labels = [f"DOC_{i}" for i in range(len(sentences))]

        # 1) word tables via plain word2vec
        super().fit(sentences)

        # 2) doc vectors trained against each doc's words
        token_lists = [self.tokenize(s) if isinstance(s, str) else list(s)
                       for s in sentences]
        n_docs, dim, dev = len(sentences), self.vector_length, self.device
        if doc_vectors is None:
            doc = uniform_init(n_docs, dim, self.seed + 1, dev)
        else:
            arr = np.asarray(doc_vectors, np.float32)
            if arr.shape != (n_docs, dim):
                raise ValueError(f"doc_vectors must have shape "
                                 f"{(n_docs, dim)}; got {arr.shape}")
            doc = torch.tensor(arr, device=dev)

        doc_ids, word_ids = [], []
        for d, toks in enumerate(token_lists):
            for t in toks:
                i = self.cache.index_of(t)
                if i >= 0:
                    doc_ids.append(d)
                    word_ids.append(i)
        if not doc_ids:
            self.doc_vectors = doc
            return self
        vocab = self._vocab_arrays()
        doc_ids_dev = torch.as_tensor(np.asarray(doc_ids, np.int32),
                                      device=dev)
        word_ids_dev = torch.as_tensor(np.asarray(word_ids, np.int32),
                                       device=dev)

        # the doc table trains in syn0's slot; copies of the shared HS and
        # negative tables co-train, as the reference's label tokens do
        tables = {"syn0": doc, "syn1": self.table.syn1.clone(),
                  "syn1neg": self.table.syn1neg.clone()}
        if self.use_adagrad:
            add_adagrad_state(tables)
        n = len(doc_ids)
        B = min(self.batch_size, n)
        n_batches = (n - 1) // B + 1
        rng = np.random.RandomState(self.seed)
        steps_total = max(1, self.doc_epochs * n_batches)
        generator = torch.Generator(device=dev).manual_seed(self.seed + 1)
        step_i = 0
        for _ in range(self.doc_epochs):
            perm = rng.permutation(n)
            # the epoch's batches, the short tail wrapped to B as np.resize
            # wraps it in the JAX package
            grid = np.stack([np.resize(perm[s:s + B], B)
                             for s in range(0, n, B)])
            alphas = np.asarray(
                [max(self.min_alpha,
                     self.alpha * (1 - (step_i + k) / steps_total))
                 for k in range(n_batches)], np.float32)
            grid_dev = torch.as_tensor(grid, device=dev)
            alphas_dev = torch.as_tensor(alphas, device=dev)
            for k in range(n_batches):
                idx = grid_dev[k]
                self._batch_step(tables, generator, doc_ids_dev[idx],
                                 word_ids_dev[idx], vocab, alphas_dev[k])
            step_i += n_batches
        self.doc_vectors = tables["syn0"]
        return self

    # -- doc query surface --------------------------------------------------
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        if label not in self.labels:
            return None
        return self.doc_vectors[self.labels.index(label)].cpu().numpy()

    def doc_similarity(self, l1: str, l2: str) -> float:
        a, b = self.doc_vector(l1), self.doc_vector(l2)
        if a is None or b is None:
            return float("nan")
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def nearest_docs(self, label: str, top: int = 5):
        v = self.doc_vector(label)
        if v is None:
            return []
        dv = self.doc_vectors.cpu().numpy()
        sims = dv @ v / (np.linalg.norm(dv, axis=1)
                         * (np.linalg.norm(v) + 1e-12) + 1e-12)
        order = np.argsort(-sims)
        return [(self.labels[i], float(sims[i])) for i in order
                if self.labels[i] != label][:top]
