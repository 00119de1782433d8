"""Input URI schemes: an `--input` string onto a DataSet.

Counterpart of `deeplearning4j_tpu/cli/schemes.py` (its own copy):
  - the builtin datasets `mnist[:n]`, `iris[:n]`, `lfw[:n]`, `curves[:n]`
    and `cifar10[:n]`, through the port's fetchers (`datasets/fetchers.py`:
    real data where a copy is on disk, else the JAX package's stand-ins);
  - `text:<path>[:seq_len]`: a char-LM DataSet, features one-hot windows
    [B, T, V], labels the next-char targets [B*T, V];
  - `csv:<path>[:label_col]`, or a bare `*.csv` path: features and one-hot
    labels from a numeric CSV, through `CSVDataFetcher` (the native parser
    where it can).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.fetchers import (
    Cifar10DataFetcher, CSVDataFetcher, CurvesDataFetcher, IrisDataFetcher,
    LFWDataFetcher, MnistDataFetcher)

#: builtin dataset -> (its fetcher, the examples it loads by default)
_BUILTIN = {"mnist": (MnistDataFetcher, 10000), "iris": (IrisDataFetcher, 150),
            "lfw": (LFWDataFetcher, 1000), "curves": (CurvesDataFetcher, 1000),
            "cifar10": (Cifar10DataFetcher, 10000)}


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
        fetcher, default_n = _BUILTIN[scheme]
        return fetcher().fetch(num_examples or (int(rest) if rest
                                                else default_n))
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
        return CSVDataFetcher(path, label_column=lc).fetch(
            num_examples or int(1e9))
    if scheme == "text":
        path, _, slen = rest.rpartition(":")
        if path and slen.isdigit():
            seq_len = int(slen)
        else:
            path, seq_len = rest, 32
        return _read_text(path, seq_len, num_examples)
    raise ValueError(
        f"unrecognized --input '{uri}': expected mnist/iris/lfw/curves/"
        f"cifar10[:n], csv:<path>[:label_col], text:<path>[:seq_len], or a "
        f".csv path")
