"""Input URI schemes: an `--input` string onto a DataSet.

Counterpart of `deeplearning4j_tpu/cli/schemes.py` (its own copy):
  - `text:<path>[:seq_len]`: a char-LM DataSet, features one-hot windows
    [B, T, V], labels the next-char targets [B*T, V];
  - `csv:<path>[:label_col]`, or a bare `*.csv` path: features and one-hot
    labels from a numeric CSV.
The builtin datasets (mnist, iris, lfw, curves, cifar10) are not ported yet.
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       labels_to_one_hot)

_BUILTIN = ("mnist", "iris", "lfw", "curves", "cifar10")


def _read_csv(path: str, label_column: int, num_examples: int) -> DataSet:
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            rows.append([float(v) for v in row])
            if len(rows) >= num_examples:
                break
    arr = np.asarray(rows, np.float32)
    lc = label_column % arr.shape[1]
    y = arr[:, lc].astype(np.int64)
    return DataSet(np.delete(arr, lc, axis=1),
                   labels_to_one_hot(y, int(y.max()) + 1))


def _read_text(path: str, seq_len: int,
               num_examples: Optional[int]) -> DataSet:
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    chars = sorted(set(text))
    idx = {c: i for i, c in enumerate(chars)}
    ids = np.asarray([idx[c] for c in text], np.int32)
    n_win = (len(ids) - 1) // seq_len
    if num_examples:
        n_win = min(n_win, num_examples)
    if n_win < 1:
        raise ValueError(f"text input too short for seq_len={seq_len}")
    xs = ids[:n_win * seq_len].reshape(n_win, seq_len)
    ys = ids[1:n_win * seq_len + 1]
    eye = np.eye(len(chars), dtype=np.float32)
    ds = DataSet(eye[xs], eye[ys])
    ds.vocab_size = len(chars)
    ds.char_index = idx
    return ds


def load_input(uri: str, label_column: int = -1,
               num_examples: Optional[int] = None) -> DataSet:
    """Resolve an --input URI to a DataSet."""
    scheme, _, rest = uri.partition(":")
    scheme = scheme.lower()
    if scheme in _BUILTIN:
        raise NotImplementedError(
            f"the builtin dataset '{scheme}' is not ported to "
            f"deeplearning4j_tpu_torch yet; see ROADMAP.md queue A item 6 "
            f"(use csv:<path> or text:<path>)")
    if scheme == "csv" or uri.endswith(".csv"):
        if scheme == "csv":
            # split at the last colon, and only before an integer, so paths
            # with ':' in them survive
            path, _, col = rest.rpartition(":")
            if path and col.lstrip("-").isdigit():
                lc = int(col)
            else:
                path, lc = rest, label_column
        else:
            path, lc = uri, label_column
        return _read_csv(path, lc, num_examples or int(1e9))
    if scheme == "text":
        path, _, slen = rest.rpartition(":")
        if path and slen.isdigit():
            seq_len = int(slen)
        else:
            path, seq_len = rest, 32
        return _read_text(path, seq_len, num_examples)
    raise ValueError(
        f"unrecognized --input '{uri}': expected csv:<path>[:label_col], "
        f"text:<path>[:seq_len], or a .csv path")
