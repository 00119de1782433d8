"""Distributed GloVe over the host coordinator.

The port of `deeplearning4j_tpu/scaleout/glove_performer.py` (reference
`scaleout/perform/models/glove/GlovePerformer.java` +
`GloveJobIterator`/aggregator): the co-occurrence pair list is chunked into
jobs; each worker runs AdaGrad steps (`glove_step`, whose four gathers
launch the scatter-add kernel in their backward on the card) against a
snapshot of the state and returns the parameter deltas and its history;
the master sums the deltas and merges the histories by max, one round per
epoch. Co-occurrence counting is chunked through the same runner (the
reference's `CoOccurrenceActor` pipeline) on the host.

w and wt start as the JAX package's `uniform(split(PRNGKey(seed)),
-0.5/D, 0.5/D)`, bit for bit (`nd/random.uniform_dtype`); the state, the
snapshots and the deltas stay on the device, and the jobs of one device
take turns at their step loops.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.embeddings import InMemoryLookupTable
from deeplearning4j_tpu_torch.models.glove import (PARAM_KEYS,
                                                    CoOccurrences, Glove,
                                                    glove_step)
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.parallel.coordinator import (LocalRunner,
                                                           StateTracker)
from deeplearning4j_tpu_torch.text.vocab import VocabCache


class DistributedGlove(Glove):
    """GloVe whose fit() runs as coordinator jobs. `epoch_losses` holds
    each epoch's summed batch losses (each taken before its step)."""

    def __init__(self, *args, n_workers: int = 4,
                 tracker: Optional[StateTracker] = None, **kw):
        super().__init__(*args, **kw)
        self.n_workers = n_workers
        self.tracker = tracker or StateTracker()
        self.epoch_losses: List[float] = []

    def _count_cooccurrences(self, token_lists) -> CoOccurrences:
        """Chunked counting: each job counts a slice of sentences, the
        aggregator merges the counts in job order (CoOccurrenceActor
        pipeline role)."""
        id_lists = [[self.cache.index_of(t) for t in toks
                     if t in self.cache] for toks in token_lists]
        chunk = max(1, len(id_lists) // self.n_workers)
        jobs = [id_lists[i:i + chunk]
                for i in range(0, len(id_lists), chunk)]

        def perform(sentence_ids):
            co = CoOccurrences(self.window)
            co.add_sentences(sentence_ids)
            return co

        def aggregate(results: List[CoOccurrences]):
            merged = CoOccurrences(self.window)
            for co in results:
                merged.merge(co)
            return merged

        runner = LocalRunner(perform, aggregate, n_workers=self.n_workers,
                             tracker=self.tracker)
        return runner.run(jobs)

    def _init_state(self, n: int) -> dict:
        """The JAX package's initial state: w, wt from the two halves of
        split(PRNGKey(seed)), zero biases, zero AdaGrad history."""
        dev, dim = self.device, self.vector_length
        k1, k2 = nd_random.split(nd_random.prng_key(self.seed, device=dev))
        scale = 0.5 / dim
        params = {
            "w": nd_random.uniform_dtype(k1, (n, dim), torch.float32,
                                         -scale, scale),
            "wt": nd_random.uniform_dtype(k2, (n, dim), torch.float32,
                                          -scale, scale),
            "b": torch.zeros(n, device=dev), "bt": torch.zeros(n, device=dev)}
        return {"params": params,
                "hist": {k: torch.zeros_like(p) for k, p in params.items()}}

    def fit(self, sentences=None) -> "DistributedGlove":
        sentences = sentences if sentences is not None else self.sentences
        token_lists = [self.tokenizer.tokenize(s) if isinstance(s, str)
                       else list(s) for s in sentences]
        self.cache = VocabCache(self.min_word_frequency).fit(token_lists)
        co = self._count_cooccurrences(token_lists)
        wi, wj, x = co.arrays()
        self.table = InMemoryLookupTable(self.cache, self.vector_length,
                                         self.seed, device=self.device)
        self.epoch_losses = []
        if len(x) == 0:
            return self

        dev = self.device
        shared = {"state": self._init_state(self.cache.num_words())}
        lock = threading.Lock()
        logx = np.log(x)
        fx = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(
            np.float32)
        wi_dev, wj_dev, logx_dev, fx_dev = (
            torch.as_tensor(a, device=dev) for a in (wi, wj, logx, fx))
        lr = torch.tensor(self.lr, dtype=torch.float32, device=dev)
        B = min(self.batch_size, len(x))
        # the jobs on one device take turns at their step loops (one
        # stream; at once they would only contend for the interpreter)
        device_lock = threading.Lock()

        def perform(idx: np.ndarray):
            with device_lock:
                return run_job(idx)

        def run_job(idx: np.ndarray):
            with lock:
                st = shared["state"]
                start = {k: p.clone() for k, p in st["params"].items()}
                hist = {k: h.clone() for k, h in st["hist"].items()}
            params = {k: p.clone() for k, p in start.items()}
            # per-job batch: padding to the dataset-global B would
            # over-train short chunks (see word2vec_performer); the short
            # tail wraps as np.resize wraps it in the JAX package
            b_job = min(B, len(idx))
            grid = torch.as_tensor(
                np.stack([np.resize(idx[s:s + b_job], b_job)
                          for s in range(0, len(idx), b_job)]), device=dev)
            loss = torch.zeros((), device=dev)
            for b in grid:
                loss += glove_step(params, hist, wi_dev[b], wj_dev[b],
                                   logx_dev[b], fx_dev[b], lr)
            # delta on params; hist merges by max (monotone accumulator)
            return {"dparams": {k: params[k] - start[k] for k in PARAM_KEYS},
                    "hist": hist, "loss": loss}

        def aggregate(results: List[dict]):
            with lock:
                st = shared["state"]
                params, hist = dict(st["params"]), dict(st["hist"])
                loss = torch.zeros((), device=dev)
                for res in results:
                    if not res:
                        continue
                    params = {k: params[k] + res["dparams"][k]
                              for k in PARAM_KEYS}
                    hist = {k: torch.maximum(hist[k], res["hist"][k])
                            for k in PARAM_KEYS}
                    loss += res["loss"]
                shared["state"] = {"params": params, "hist": hist}
            return loss

        rng = np.random.RandomState(self.seed)
        for _ in range(self.epochs):
            perm = rng.permutation(len(x))
            chunk = max(1, len(perm) // self.n_workers)
            jobs = [perm[i:i + chunk]
                    for i in range(0, len(perm), chunk)]
            runner = LocalRunner(perform, aggregate,
                                 n_workers=self.n_workers,
                                 tracker=self.tracker)
            self.epoch_losses.append(float(runner.run(jobs)))

        p = shared["state"]["params"]
        self.params = p
        self.table.syn0 = p["w"] + p["wt"]
        return self
