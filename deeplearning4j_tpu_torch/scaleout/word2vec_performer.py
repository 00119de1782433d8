"""Distributed Word2Vec over the host coordinator.

The port of `deeplearning4j_tpu/scaleout/word2vec_performer.py` (reference
`Word2VecPerformer.java:50-426` + `Word2VecJobIterator` /
`Word2VecJobAggregator`): workers train pair chunks against a snapshot of
the lookup tables and hand back deltas; the master merges the deltas into
the shared tables each round (BSP) or as each job ends (HogWild).

Every job runs on the tables' device (the jobs of one device take turns
at their step loops, which share its stream). A job snapshots the tables
there, steps through its pairs with `w2v_step` (the single-process
model's step: each gather is `gather_rows`, whose backward is the
scatter-add kernel on the card), and returns the whole-table deltas
`new - start`, still on the device. Untouched rows have a delta of exactly 0, so adding a whole table
gives the rows of the JAX package's sparse {row -> delta} merge, and the
merge adds the jobs in job order, each add the elementwise float32 add
numpy makes there. Nothing is read back to the host per job.

The randomness is the JAX package's own: the pair chunks come from
`RandomState(seed)`, and the negatives of step s of job j in epoch e from
`randint(fold_in(fold_in(fold_in(PRNGKey(seed), e), j), s), (B, K), 0,
len(unigram table))` (`nd/random.py`, bit for bit `jax.random.randint`;
the keys are hashed on the host, the draws on the device), so a BSP run
is deterministic for a fixed seed across any interleaving of the workers,
and equal to the JAX package's within float32 rounding.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.word2vec import (SYN_KEYS, Word2Vec,
                                                       add_adagrad_state,
                                                       w2v_step)
from deeplearning4j_tpu_torch.nd import random as nd_random
from deeplearning4j_tpu_torch.parallel.coordinator import (LocalRunner,
                                                           StateTracker)


def job_batches(c_np: np.ndarray, t_np: np.ndarray, batch: int
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """A job's pairs cut into steps of min(batch, len) pairs, the last step
    filled up by repeating its own pairs (`np.resize`), as the JAX package
    pads it. Returns (centers, contexts) [steps * b_job] and b_job."""
    b_job = min(batch, len(c_np))
    cs, ts = [], []
    for s in range(0, len(c_np), b_job):
        cb, tb = c_np[s:s + b_job], t_np[s:s + b_job]
        if len(cb) < b_job:
            pad = b_job - len(cb)
            cb = np.concatenate([cb, np.resize(cb, pad)])
            tb = np.concatenate([tb, np.resize(tb, pad)])
        cs.append(cb)
        ts.append(tb)
    return np.concatenate(cs), np.concatenate(ts), b_job


class DistributedWord2Vec(Word2Vec):
    """Word2Vec whose fit() runs as coordinator jobs.

    hogwild=False → BSP rounds (one per epoch): every worker trains on the
    same table snapshot, deltas are summed then applied
    (iterative-reduce semantics).
    hogwild=True  → each job applies its deltas to the shared tables the
    moment it finishes (HogWildWorkRouter semantics); snapshot staleness
    between jobs is racy-by-design, like the reference.
    """

    def __init__(self, *args, n_workers: int = 4, hogwild: bool = False,
                 jobs_per_round: Optional[int] = None,
                 tracker: Optional[StateTracker] = None, **kw):
        super().__init__(*args, **kw)
        self.n_workers = n_workers
        self.hogwild = hogwild
        self.jobs_per_round = jobs_per_round
        self.tracker = tracker or StateTracker()

    def fit(self, sentences=None) -> "DistributedWord2Vec":
        sentences = sentences if sentences is not None else self.sentences
        token_lists = [self.tokenize(s) if isinstance(s, str) else list(s)
                       for s in sentences]
        if self.cache is None:
            self.build_vocab(token_lists)
        ids = [np.asarray([self.cache.index_of(t) for t in toks
                           if t in self.cache], np.int32)
               for toks in token_lists]
        centers, contexts = self._pairs(ids)
        if len(centers) == 0:
            return self

        dev = self.device
        codes, points, mask, neg_table = self._vocab_arrays()
        if self.table.syn1neg is None:
            self.table.syn1neg = torch.zeros(self.cache.num_words(),
                                             self.vector_length, device=dev)
        # the table's own tensors: the merges write them in place
        tables = {k: getattr(self.table, k) for k in SYN_KEYS}
        if self.use_adagrad:
            # per-word AdaGrad history rides the same delta machinery:
            # h increments are sums of g^2, so summing worker deltas is
            # exactly the distributed-AdaGrad accumulator merge
            add_adagrad_state(tables)

        n_jobs = self.jobs_per_round or self.n_workers
        pairs_total = max(1, self.epochs * len(centers))
        base_key = (0, self.seed & 0xFFFFFFFF)  # PRNGKey(seed), on the host
        lock = threading.Lock()
        # the jobs on one device take turns at their step loops: they share
        # its stream, so running them at once would only have the worker
        # threads contend for the interpreter's lock
        device_lock = threading.Lock()

        def _apply(deltas: dict) -> None:
            for name, d in deltas.items():
                tables[name].add_(d)

        def perform(work):
            """Train one pair chunk against the current snapshot; return
            the tables' deltas (Word2VecResult role)."""
            epoch_i, job_i, pair_offset, c_np, t_np = work
            with device_lock:
                return run_job(epoch_i, job_i, pair_offset, c_np, t_np)

        def run_job(epoch_i, job_i, pair_offset, c_np, t_np):
            with lock:  # a consistent snapshot under hogwild
                start = {k: v.clone() for k, v in tables.items()}
            cur = {k: v.clone() for k, v in start.items()}
            job_key = nd_random.fold_in_host(
                nd_random.fold_in_host(base_key, epoch_i), job_i)
            # per-job batch: padding a short chunk to the global batch size
            # would over-train its pairs relative to the serial model
            c_all, t_all, b_job = job_batches(c_np, t_np, self.batch_size)
            n_steps = len(c_all) // b_job
            # linear alpha decay by global pair progress, rounded to
            # float32 as the JAX package passes it
            done = (epoch_i * len(centers) + pair_offset
                    + b_job * np.arange(n_steps))
            alphas = np.maximum(self.min_alpha,
                                self.alpha * (1 - done / pairs_total))
            c_dev, t_dev, alphas_dev = (
                torch.as_tensor(a, device=dev)
                for a in (c_all, t_all, alphas.astype(np.float32)))
            for s in range(n_steps):
                cb = c_dev[s * b_job:(s + 1) * b_job]
                tb = t_dev[s * b_job:(s + 1) * b_job]
                neg = None
                if self.negative > 0:
                    slots = nd_random.randint(
                        nd_random.fold_in_host(job_key, s),
                        (b_job, self.negative), 0, neg_table.shape[0],
                        device=dev)
                    neg = neg_table[slots]
                w2v_step(cur, cb, tb, codes[tb], points[tb], mask[tb], neg,
                         alphas_dev[s], self.use_adagrad)
            deltas = {k: cur[k] - start[k] for k in tables}
            if self.hogwild:  # apply eagerly, return nothing to aggregate
                with lock:
                    _apply(deltas)
                return {}
            return deltas

        def aggregate(results: List[dict]):
            """Merge the deltas into the shared tables, job by job
            (Word2VecJobAggregator.accumulate semantics: sum deltas)."""
            with lock:
                for res in results:
                    if res:
                        _apply(res)
            return None

        rng = np.random.RandomState(self.seed)
        for epoch_i in range(self.epochs):
            perm = rng.permutation(len(centers))
            chunk = max(1, len(perm) // n_jobs)
            jobs = [(epoch_i, j, i, centers[perm[i:i + chunk]],
                     contexts[perm[i:i + chunk]])
                    for j, i in enumerate(range(0, len(perm), chunk))]
            runner = LocalRunner(perform, aggregate,
                                 n_workers=self.n_workers,
                                 hogwild=self.hogwild, tracker=self.tracker)
            runner.run(jobs)
        return self
