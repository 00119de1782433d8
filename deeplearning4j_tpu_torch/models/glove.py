"""GloVe — co-occurrence counting + AdaGrad weighted least squares.

The port of `deeplearning4j_tpu/models/glove.py` (reference
`models/glove/Glove.java`, `CoOccurrences.java`): windowed co-occurrence
counts with 1/distance weights on the host, then AdaGrad over
sum f(x) (w_i . wt_j + b_i + bt_j - log x)^2 in batches. The four tables
(w, wt and the 1-D biases b, bt) are read through `gather_rows`, so every
step launches the scatter-add kernel four times on the card (D = 1 for the
biases). The tables are updated in place.

w and wt start as U(-0.5/D, 0.5/D) from a CPU generator seeded with `seed`
(the JAX package draws them from threefry), or from the arrays passed to
`fit` (e.g. the JAX package's, carried across); the biases start at zero.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.embeddings import InMemoryLookupTable
from deeplearning4j_tpu_torch.nd.kernels import gather_rows
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.text.corpus import TokenCorpus
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.text.vocab import VocabCache

PARAM_KEYS = ("w", "wt", "b", "bt")


#: tokens a batch of `CoOccurrences.add_sentences` (its adds take ~480
#: bytes a token at window 15)
_BATCH_TOKENS = 1 << 20


class CoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/distance weighting
    (`CoOccurrences.java` contract). The JAX package's adds each pair to a
    dict in a Python loop; here a batch of sentences becomes one array of
    the same adds in the same order, folded in by key: the pairs come out
    in the dict's order (first occurrence) and each count is the same
    float64 sum, added in the same order (`np.bincount` adds in input
    order)."""

    def __init__(self, window: int = 15):
        self.window = window
        self.keys = np.zeros(0, np.int64)  # a << 32 | b
        self.values = np.zeros(0, np.float64)

    def add_sentence(self, ids: Sequence[int]) -> None:
        self.add_sentences([ids])

    def add_sentences(self, id_lists: Iterable[Sequence[int]]) -> None:
        """Every sentence's adds, folded in a batch of about _BATCH_TOKENS
        tokens at a time (the same counts: each batch folds in after the
        one before), so the adds' arrays stay bounded on a long corpus."""
        batch, n = [], 0
        for ids in id_lists:
            batch.append(ids)
            n += len(ids)
            if n >= _BATCH_TOKENS:
                self._add_batch(batch)
                batch, n = [], 0
        if batch:
            self._add_batch(batch)

    def _add_batch(self, id_lists: Sequence[Sequence[int]]) -> None:
        """For token i, each j of the window before it (ascending) with a
        different id adds 1/(i - j) to (a, b), then to (b, a)."""
        lens = np.array([len(s) for s in id_lists], np.int64)
        if lens.sum() == 0:
            return
        ids = np.concatenate([np.asarray(s, np.int64) for s in id_lists
                              if len(s)])
        pos = np.arange(len(ids))
        start = np.repeat(np.cumsum(lens) - lens, lens)
        dist = np.arange(self.window, 0, -1)
        j = pos[:, None] - dist[None, :]
        a = np.broadcast_to(ids[:, None], j.shape)
        b = ids[np.maximum(j, 0)]
        valid = (j >= start[:, None]) & (a != b)
        pairs = np.stack([a << 32 | b, b << 32 | a], axis=-1)[valid]
        w = np.broadcast_to(1.0 / dist, j.shape)[valid]
        self._fold(pairs.reshape(-1), np.repeat(w, 2))

    def merge(self, other: "CoOccurrences") -> None:
        """Add `other`'s counts, key by key in its order."""
        self._fold(other.keys, other.values)

    def _fold(self, keys: np.ndarray, weights: np.ndarray) -> None:
        self.keys, self.values = _sum_by_key(
            np.concatenate([self.keys, keys]),
            np.concatenate([self.values, weights]))

    def arrays(self):
        return ((self.keys >> 32).astype(np.int32),
                (self.keys & 0xFFFFFFFF).astype(np.int32),
                self.values.astype(np.float32))


def _sum_by_key(keys: np.ndarray, weights: np.ndarray):
    """The distinct keys (a << 32 | b) in order of first occurrence, and
    each one's weights summed in input order. One sort of (compact key,
    position) pairs does it where both fit in 62 bits; else np.unique's
    stable argsort."""
    if len(keys) == 0:
        return keys, weights
    a, b = keys >> 32, keys & 0xFFFFFFFF
    v = int(max(a.max(), b.max())) + 1
    compact = a * v + b
    pos_bits = max(1, (len(keys) - 1).bit_length())
    if int(compact.max()).bit_length() + pos_bits > 62:
        uniq, first, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
        sums = np.bincount(inv.reshape(-1), weights, minlength=len(uniq))
        order = np.argsort(first, kind="stable")
        return uniq[order], sums[order]
    srt = np.sort(compact << pos_bits | np.arange(len(keys)))
    pos, key = srt & ((1 << pos_bits) - 1), srt >> pos_bits
    head = np.empty(len(srt), bool)
    head[0] = True
    np.not_equal(key[1:], key[:-1], out=head[1:])
    group = np.cumsum(head) - 1
    sums = np.bincount(group, weights[pos], minlength=int(group[-1]) + 1)
    first = pos[head]
    g_bits = max(1, (len(first) - 1).bit_length())
    order = np.sort(first << g_bits | np.arange(len(first))) & (
        (1 << g_bits) - 1)
    key = key[head][order]
    return (key // v) << 32 | key % v, sums[order]


def glove_loss(params: Dict[str, torch.Tensor], wi, wj, logx,
               fx) -> torch.Tensor:
    """sum fx * (w[wi] . wt[wj] + b[wi] + bt[wj] - logx)^2 over a batch."""
    d = (torch.einsum("bd,bd->b", gather_rows(params["w"], wi),
                      gather_rows(params["wt"], wj))
         + gather_rows(params["b"], wi) + gather_rows(params["bt"], wj)
         - logx)
    return torch.sum(fx * d * d)


def glove_step(params: Dict[str, torch.Tensor],
               hist: Dict[str, torch.Tensor], wi, wj, logx, fx,
               lr) -> torch.Tensor:
    """One AdaGrad step in place: h += g^2; p -= lr * g / (sqrt(h) + 1e-8).
    Returns the loss before the step."""
    leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
    loss = glove_loss(leaves, wi, wj, logx, fx)
    grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_KEYS])
    with torch.no_grad():
        for k, g in zip(PARAM_KEYS, grads):
            hist[k].add_(g * g)
            params[k].sub_(lr * g / (torch.sqrt(hist[k]) + 1e-8))
    return loss.detach()


class Glove:
    def __init__(self, sentences=None, tokenizer_factory=None,
                 vector_length: int = 100, window: int = 15,
                 min_word_frequency: int = 1, x_max: float = 100.0,
                 alpha: float = 0.75, lr: float = 0.05,
                 epochs: int = 25, batch_size: int = 4096,
                 seed: int = 123, device=None):
        self.sentences = sentences
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.x_max = x_max
        self.alpha = alpha
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.cache: Optional[VocabCache] = None
        self.table: Optional[InMemoryLookupTable] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None

    def _init_params(self, n: int, init) -> Dict[str, torch.Tensor]:
        dim, dev = self.vector_length, self.device
        if init is not None:
            want = {"w": (n, dim), "wt": (n, dim), "b": (n,), "bt": (n,)}
            out = {}
            for k in PARAM_KEYS:
                arr = np.asarray(init[k], np.float32)
                if arr.shape != want[k]:
                    raise ValueError(f"init[{k!r}] must have shape "
                                     f"{want[k]}; got {arr.shape}")
                out[k] = torch.tensor(arr, device=dev)
            return out
        gen = torch.Generator().manual_seed(self.seed)
        scale = 0.5 / dim
        w, wt = ((torch.rand(n, dim, generator=gen) * 2 - 1) * scale
                 for _ in range(2))
        return {"w": w.to(dev), "wt": wt.to(dev),
                "b": torch.zeros(n, device=dev),
                "bt": torch.zeros(n, device=dev)}

    def fit(self, sentences=None, init=None) -> "Glove":
        """Count co-occurrences and train. `init`, if given, holds the
        starting tables as arrays: w and wt [V, D], b and bt [V]."""
        sentences = sentences if sentences is not None else self.sentences
        token_lists = TokenCorpus(sentences, self.tokenizer.tokenize)
        self.cache = VocabCache(self.min_word_frequency).fit(token_lists)
        co = CoOccurrences(self.window)
        co.add_sentences([self.cache.index_of(t) for t in toks
                          if t in self.cache] for toks in token_lists)
        wi, wj, x = co.arrays()
        self.table = InMemoryLookupTable(self.cache, self.vector_length,
                                         self.seed, device=self.device)
        if len(x) == 0:
            return self

        dev = self.device
        params = self._init_params(self.cache.num_words(), init)
        hist = {k: torch.zeros_like(p) for k, p in params.items()}
        logx = np.log(x)
        fx = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(
            np.float32)
        wi_dev, wj_dev, logx_dev, fx_dev = (
            torch.as_tensor(a, device=dev) for a in (wi, wj, logx, fx))
        lr = torch.tensor(self.lr, dtype=torch.float32, device=dev)
        rng = np.random.RandomState(self.seed)
        B = min(self.batch_size, len(x))
        for _ in range(self.epochs):
            perm = rng.permutation(len(x))
            # the epoch's batches, the short tail wrapped to B as np.resize
            # wraps it in the JAX package
            grid = torch.as_tensor(
                np.stack([np.resize(perm[s:s + B], B)
                          for s in range(0, len(x), B)]), device=dev)
            for idx in grid:
                glove_step(params, hist, wi_dev[idx], wj_dev[idx],
                           logx_dev[idx], fx_dev[idx], lr)

        # final vectors = w + wt (standard GloVe export)
        self.params = params
        self.table.syn0 = params["w"] + params["wt"]
        return self

    def vector(self, word):
        return self.table.vector(word)

    def similarity(self, a, b):
        return self.table.similarity(a, b)

    def words_nearest(self, word, top=10):
        return self.table.words_nearest(word, top)
