"""MNIST IDX file parsing, and the MNIST-shaped stand-in.

Counterpart of `deeplearning4j_tpu/datasets/mnist.py` (its own copy):
`read_idx` (the native parser for uncompressed files, else Python, which
also reads .gz), `find_mnist_dir` ($MNIST_DIR, ~/MNIST, the checkout's
`data/mnist`), `load_real_mnist`, and `synthetic_mnist`, the stand-in when
no copy is on disk: the 8x8 handwritten digits upscaled to 28x28. Its
digits come from `data/digits.csv.gz` in this package (scikit-learn's
bundled copy, parsed as scikit-learn parses it), so the stand-in is the
JAX package's array for array without scikit-learn installed.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

DEFAULT_DIRS = (
    os.path.expanduser("~/MNIST"),
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "mnist"),
)

FILES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}

DIGITS_CSV = os.path.join(os.path.dirname(__file__), "data",
                          "digits.csv.gz")


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx_python(path: str) -> np.ndarray:
    """Parse an IDX file (or `path` + ".gz") in Python."""
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        if dtype_code != 0x08:  # unsigned byte: the only MNIST dtype
            raise ValueError(
                f"unsupported IDX dtype 0x{dtype_code:02x} in {path}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (images or labels) into a uint8 array: through the
    native parser (`native/dataloader.cc`) when the library is available
    and the file is uncompressed, else in Python."""
    if os.path.exists(path):  # the native path cannot read .gz
        from deeplearning4j_tpu_torch.native import native_read_idx

        arr = native_read_idx(path)
        if arr is not None:
            return arr
    return read_idx_python(path)


def find_mnist_dir() -> Optional[str]:
    env = os.environ.get("MNIST_DIR")
    for d in ([env] if env else []) + list(DEFAULT_DIRS):
        if d and os.path.isdir(d):
            for cand in FILES["train_images"]:
                p = os.path.join(d, cand)
                if os.path.exists(p) or os.path.exists(p + ".gz"):
                    return d
    return None


def load_real_mnist(directory: str, train: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray]:
    key_i = "train_images" if train else "test_images"
    key_l = "train_labels" if train else "test_labels"

    def resolve(names):
        for n in names:
            p = os.path.join(directory, n)
            if os.path.exists(p) or os.path.exists(p + ".gz"):
                return p
        raise FileNotFoundError(f"none of {names} under {directory}")

    images = read_idx(resolve(FILES[key_i])).astype(np.float32) / 255.0
    labels = read_idx(resolve(FILES[key_l])).astype(np.int64)
    return images.reshape(len(images), -1), labels


def load_digits() -> Tuple[np.ndarray, np.ndarray]:
    """The 1,797 8x8 digits as (float64 [1797, 64], int64 [1797]): the
    vendored CSV parsed as scikit-learn's `load_digits` parses it (64
    pixel columns, then the target)."""
    with gzip.open(DIGITS_CSV, mode="rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1], data[:, -1].astype(np.int64)


def synthetic_mnist(n: int, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped (784-dim, 10-class) data from the upscaled 8x8
    digits."""
    X8, y = load_digits()
    X8 = (X8 / 16.0).reshape(-1, 8, 8).astype(np.float32)
    # nearest-neighbour upscale 8x8 -> 24x24, padded to 28x28
    X24 = np.repeat(np.repeat(X8, 3, axis=1), 3, axis=2)
    X28 = np.pad(X24, ((0, 0), (2, 2), (2, 2)))
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(X28), size=n, replace=n > len(X28))
    return X28[idx].reshape(n, 784), y[idx].astype(np.int64)
