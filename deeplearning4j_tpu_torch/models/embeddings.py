"""Embedding lookup tables + word-vector query/serialization API.

The port of `deeplearning4j_tpu/models/embeddings.py` (reference
`InMemoryLookupTable.java`, `WordVectors`/`WordVectorsImpl`,
`WordVectorSerializer`). The tables are torch tensors on an explicit device
(CUDA unless the caller asks for the CPU). syn0 starts as U(-0.5, 0.5) / D
from a CPU `torch.Generator` seeded with `seed`, so a table starts the same
on every device; the JAX package draws from threefry instead, and
`load_numpy` carries its tables across where the two must compute the same
thing. The unigram tables are numpy, as in JAX. The writers produce the
same files, byte for byte, as the JAX package's, and each package reads
the other's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.text.vocab import VocabCache


def uniform_init(rows: int, cols: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """U(-0.5, 0.5) / cols as float32 [rows, cols], drawn on the CPU from a
    generator seeded with `seed` and moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    return ((torch.rand(rows, cols, generator=gen) - 0.5) / cols).to(device)


class InMemoryLookupTable:
    """syn0 (word vectors), syn1 (HS inner nodes), syn1neg (negative
    sampling context vectors), unigram sample table."""

    def __init__(self, cache: VocabCache, vector_length: int = 100,
                 seed: int = 123, negative: float = 0.0, device=None):
        self.cache = cache
        self.vector_length = vector_length
        self.negative = negative
        self.seed = seed
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        self.reset_weights()

    def reset_weights(self) -> None:
        """syn0 ~ U(-0.5, 0.5)/vec_len; syn1 zeros; syn1neg zeros when
        negative sampling is on (reference `resetWeights`
        InMemoryLookupTable.java:100-106)."""
        n, d = self.cache.num_words(), self.vector_length
        self.syn0 = uniform_init(n, d, self.seed, self.device)
        self.syn1 = torch.zeros(max(1, n - 1), d, device=self.device)
        if self.negative > 0:
            self.syn1neg = torch.zeros(n, d, device=self.device)

    def load_numpy(self, syn0=None, syn1=None, syn1neg=None
                   ) -> "InMemoryLookupTable":
        """Replace the named tables with float32 copies of the given arrays
        (e.g. the JAX package's tables as numpy), on this table's device.
        Each must have the shape the vocabulary gives it."""
        n, d = self.cache.num_words(), self.vector_length
        want = {"syn0": (n, d), "syn1": (max(1, n - 1), d),
                "syn1neg": (n, d)}
        for name, arr in (("syn0", syn0), ("syn1", syn1),
                          ("syn1neg", syn1neg)):
            if arr is None:
                continue
            arr = np.asarray(arr, np.float32)
            if arr.shape != want[name]:
                raise ValueError(f"load_numpy: {name} must have shape "
                                 f"{want[name]}; got {arr.shape}")
            setattr(self, name, torch.tensor(arr, device=self.device))
        return self

    def unigram_table_probs(self, power: float = 0.75) -> np.ndarray:
        """Noise distribution counts^0.75 (the reference's `table` array,
        :108-130, as probabilities), the input of `unigram_table`."""
        counts = self.cache.counts() ** power
        return (counts / counts.sum()).astype(np.float32)

    def unigram_table(self, size: int = 1 << 20,
                      power: float = 0.75) -> np.ndarray:
        """word2vec.c-style negative-sampling table (ref
        InMemoryLookupTable.java:108-130 `makeTable`): word i occupies a
        slot span proportional to count^0.75, so drawing a negative is one
        uniform int and one gather."""
        probs = self.unigram_table_probs(power).astype(np.float64)
        cum = np.cumsum(probs)
        cum[-1] = 1.0  # guard fp drift so searchsorted never returns V
        return np.searchsorted(
            cum, (np.arange(size) + 0.5) / size).astype(np.int32)

    # -- WordVectors query surface ----------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        i = self.cache.index_of(word)
        return None if i < 0 else self.syn0[i].detach().cpu().numpy()

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.vector(w1), self.vector(w2)
        if a is None or b is None:
            return float("nan")
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def words_nearest(self, word_or_vec, top: int = 10,
                      exclude: Sequence[str] = ()) -> List[Tuple[str, float]]:
        """The `top` words of highest cosine similarity to a word (itself
        excluded) or a vector; the similarities are computed on the table's
        device."""
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            exclude = list(exclude) + [word_or_vec]
            if v is None:
                return []
        else:
            v = np.asarray(word_or_vec)
        syn0 = self.syn0.detach()
        vt = torch.as_tensor(np.asarray(v, np.float32), device=syn0.device)
        norms = (torch.linalg.vector_norm(syn0, dim=1)
                 * (torch.linalg.vector_norm(vt) + 1e-12))
        sims = (syn0 @ vt / norms.clamp_min(1e-12)).cpu().numpy()
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.cache.word_at_index(int(i))
            if w in exclude:
                continue
            out.append((w, float(sims[i])))
            if len(out) >= top:
                break
        return out

    def analogy(self, a: str, b: str, c: str, top: int = 5):
        """a : b :: c : ?  (king - man + woman -> queen)."""
        va, vb, vc = self.vector(a), self.vector(b), self.vector(c)
        if va is None or vb is None or vc is None:
            return []
        return self.words_nearest(vb - va + vc, top=top,
                                  exclude=[a, b, c])


# -- serialization (WordVectorSerializer parity) ---------------------------

def _syn0_numpy(table: InMemoryLookupTable) -> np.ndarray:
    return table.syn0.detach().to("cpu", torch.float32).numpy()


def write_word_vectors(table: InMemoryLookupTable, path: str) -> None:
    """word2vec C *text* format: header 'V D', then 'word v1 ... vD', each
    value as `%.6g` (the JAX package's writer, character for character)."""
    syn0 = _syn0_numpy(table)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
        for i, w in enumerate(table.cache.words()):
            vec = " ".join(f"{x:.6g}" for x in syn0[i])
            f.write(f"{w} {vec}\n")


def read_word_vectors(path: str, device=None) -> InMemoryLookupTable:
    """A table (syn0 only) from the word2vec C text format, on `device`."""
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        d = int(header[1])
        words, vecs = [], []
        for line in f:
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            vecs.append([float(x) for x in parts[1:d + 1]])
    return _table_from(words, np.asarray(vecs, np.float32), d, device)


def _table_from(words: List[str], vecs: np.ndarray, d: int,
                device) -> InMemoryLookupTable:
    cache = VocabCache()
    cache.fit([words])  # one occurrence each; preserves all words
    syn0 = np.zeros((len(words), d), np.float32)
    for w, v in zip(words, vecs):
        syn0[cache.index_of(w)] = v
    return InMemoryLookupTable(cache, d, device=device).load_numpy(syn0=syn0)


def write_word_vectors_binary(table: InMemoryLookupTable, path: str) -> None:
    """word2vec C *binary* format (the `loadGoogleModel(binary=true)` format
    of the reference's `WordVectorSerializer.java`): ASCII header
    "V D\\n", then per word: "word" + 0x20 + D little-endian f32s + "\\n".
    The bytes equal the JAX package's writer's."""
    syn0 = _syn0_numpy(table)
    with open(path, "wb") as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n".encode("utf-8"))
        for i, w in enumerate(table.cache.words()):
            f.write(w.encode("utf-8") + b" ")
            f.write(syn0[i].astype("<f4").tobytes())
            f.write(b"\n")


def read_word_vectors_binary(path: str, device=None) -> InMemoryLookupTable:
    """Read the word2vec C binary format (google-news model layout) onto
    `device`. Tolerates both the canonical trailing "\\n" per row and the
    space-separated variant some writers emit."""
    with open(path, "rb") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        row_bytes = d * 4
        words, vecs = [], []
        for _ in range(n):
            # word = bytes up to the first 0x20 (skipping leading newlines)
            chars = []
            while True:
                c = f.read(1)
                if not c:
                    raise ValueError("truncated word2vec binary file")
                if c == b" ":
                    break
                if c != b"\n":
                    chars.append(c)
            words.append(b"".join(chars).decode("utf-8"))
            vecs.append(np.frombuffer(f.read(row_bytes), dtype="<f4"))
    return _table_from(words, np.asarray(vecs, np.float32), d, device)
