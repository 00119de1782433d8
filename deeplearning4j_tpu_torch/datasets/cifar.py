"""CIFAR-10 python-batch parsing, and the CIFAR-shaped stand-in.

Counterpart of `deeplearning4j_tpu/datasets/cifar.py` (its own copy):
`_read_batch` reads one pickled batch of the canonical `cifar-10-batches-py`
layout (``data`` uint8 [N, 3072], channel-major RGB, and ``labels``),
`find_cifar10_dir` looks in $CIFAR10_DIR, ~/CIFAR10 and the checkout's
`data/cifar10`, `load_real_cifar10` reads the batches it needs, and
`synthetic_cifar10` is the deterministic stand-in with the real shapes
(smooth class templates plus noise), the JAX package's array for array.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

BATCH_DIR = "cifar-10-batches-py"
TRAIN_BATCHES = tuple(f"data_batch_{i}" for i in range(1, 6))
TEST_BATCH = "test_batch"

DEFAULT_DIRS = (
    os.path.expanduser("~/CIFAR10"),
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "cifar10"),
)


def _read_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"], np.uint8)
    labels = np.asarray(d[b"labels"], np.int64)
    return data, labels


def find_cifar10_dir() -> Optional[str]:
    """Locate a `cifar-10-batches-py` directory ($CIFAR10_DIR, ~/CIFAR10,
    or the repo-local data dir), accepting either the batch dir itself or
    its parent."""
    env = os.environ.get("CIFAR10_DIR")
    for d in ([env] if env else []) + list(DEFAULT_DIRS):
        if not d:
            continue
        for cand in (os.path.join(d, BATCH_DIR), d):
            if os.path.exists(os.path.join(cand, TRAIN_BATCHES[0])):
                return cand
    return None


def load_real_cifar10(directory: str, train: bool = True,
                      num_examples: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X [N, 3072] float32 in [0,1], y [N] int64).  Stops reading
    batch files once `num_examples` rows are on hand (each holds 10k —
    a 512-example bench shouldn't unpickle all 50k images)."""
    names = TRAIN_BATCHES if train else (TEST_BATCH,)
    xs, ys = [], []
    have = 0
    for name in names:
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            if train and xs:  # partial copy: train on what's present
                break
            raise IOError(f"missing CIFAR-10 batch {path}")
        x, y = _read_batch(path)
        xs.append(x)
        ys.append(y)
        have += len(y)
        if num_examples is not None and have >= num_examples:
            break
    X = np.concatenate(xs).astype(np.float32) / 255.0
    y = np.concatenate(ys)
    if num_examples is not None:
        X, y = X[:num_examples], y[:num_examples]
    return X, y


def synthetic_cifar10(num_examples: int, seed: int = 11
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic stand-in with the real shapes/classes: 10 smooth
    class-dependent color templates + noise, so convnets can actually
    separate the classes (pure noise would make convergence tests
    meaningless)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    templates = np.zeros((10, 3, 32, 32), np.float32)
    for c in range(10):
        fx, fy = rng.rand(2) * 4 + 1
        phase = rng.rand(3, 1, 1) * 2 * np.pi
        templates[c] = 0.5 + 0.4 * np.sin(
            2 * np.pi * (fx * xx + fy * yy)[None] + phase)
    y = rng.randint(0, 10, num_examples)
    X = templates[y] + 0.15 * rng.randn(
        num_examples, 3, 32, 32).astype(np.float32)
    return np.clip(X, 0, 1).reshape(num_examples, 3072), y
