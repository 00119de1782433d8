"""Dataset fetchers and ready-made iterators.

Counterpart of `deeplearning4j_tpu/datasets/fetchers.py` (its own copy):
`IrisDataFetcher`, `MnistDataFetcher` (binarised at 30/255 by default),
`LFWDataFetcher`, `Cifar10DataFetcher`, `CurvesDataFetcher` and
`CSVDataFetcher` (through the native CSV parser where it can), and the
`*_iterator` helpers. Real data is read where a copy is on disk or a
source URL is configured; otherwise each fetcher gives the JAX package's
deterministic stand-in with the same shapes and classes. Iris is read from
`data/iris.csv` in this package (scikit-learn's bundled copy, parsed as
scikit-learn parses it), so no fetcher needs scikit-learn; LFW tries
scikit-learn's local cache inside its fallback chain, as the JAX package
does, and without scikit-learn lands on the stand-in.
"""

from __future__ import annotations

import csv as csv_mod
import logging
import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets import mnist as mnist_mod
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       labels_to_one_hot)
from deeplearning4j_tpu_torch.datasets.iterator import (DataSetIterator,
                                                        ListDataSetIterator)

log = logging.getLogger("deeplearning4j_tpu_torch")

IRIS_CSV = os.path.join(os.path.dirname(__file__), "data", "iris.csv")


def load_iris():
    """(float64 [150, 4], int64 [150]): the vendored CSV parsed as
    scikit-learn's `load_iris` parses it (a header row of n_samples,
    n_features and the target names, then 4 floats and an int a row)."""
    with open(IRIS_CSV, encoding="utf-8", newline="") as f:
        reader = csv_mod.reader(f)
        header = next(reader)
        n, d = int(header[0]), int(header[1])
        data = np.empty((n, d))
        target = np.empty((n,), dtype=np.int64)
        for i, row in enumerate(reader):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = int(row[-1])
    return data, target


class BaseDataFetcher:
    """Loads a whole corpus once and serves DataSets of it."""

    def fetch(self, num_examples: int) -> DataSet:
        raise NotImplementedError


class IrisDataFetcher(BaseDataFetcher):
    NUM_EXAMPLES = 150

    def fetch(self, num_examples: int = 150) -> DataSet:
        X, y = load_iris()
        X = X.astype(np.float32)
        n = min(num_examples, len(X))
        return DataSet(X[:n], labels_to_one_hot(y[:n], 3))


class MnistDataFetcher(BaseDataFetcher):
    """MNIST with binarization threshold parity (ref threshold 30: pixels are
    0..255; here features are already /255 so the threshold is 30/255)."""

    def __init__(self, binarize: bool = True, train: bool = True):
        self.binarize = binarize
        self.train = train

    def fetch(self, num_examples: int = 60000) -> DataSet:
        d = mnist_mod.find_mnist_dir()
        if d is None and os.environ.get("DL4J_MNIST_URL"):
            # no local copy but a source is configured: download + verify
            # (MnistFetcher.java downloadAndUntar parity; datasets/fetch.py)
            from deeplearning4j_tpu_torch.datasets.fetch import fetch_mnist

            try:
                d = fetch_mnist()
            except IOError as e:
                log.warning("MNIST download failed (%r); using synthetic", e)
        if d is not None:
            X, y = mnist_mod.load_real_mnist(d, self.train)
            X, y = X[:num_examples], y[:num_examples]
        else:
            X, y = mnist_mod.synthetic_mnist(num_examples)
        if self.binarize:
            X = (X > 30.0 / 255.0).astype(np.float32)
        return DataSet(X, labels_to_one_hot(y, 10))


class LFWDataFetcher(BaseDataFetcher):
    """Labeled Faces in the Wild; synthetic fallback keeps shapes (62x47)."""

    def __init__(self, n_classes: int = 10):
        self.n_classes = n_classes

    def fetch(self, num_examples: int = 1000) -> DataSet:
        # preferred real path (LFWLoader.java parity): a downloaded (or
        # pre-existing) person-per-directory image tree read through
        # ImageRecordReader; falls back to the sklearn cache, then synthetic.
        # Gate on LFW_DIR being a directory at all — fetch_lfw itself
        # handles both the lfw/-prefixed and flat archive layouts
        root = os.environ.get("LFW_DIR")
        if (root and os.path.isdir(root)) or os.environ.get("DL4J_LFW_URL"):
            try:
                from deeplearning4j_tpu_torch.datasets.fetch import fetch_lfw
                from deeplearning4j_tpu_torch.datasets.records import (
                    image_folder_dataset)

                ds = image_folder_dataset(fetch_lfw(), 62, 47)
                n = min(num_examples, len(ds.features))
                return DataSet(ds.features[:n], ds.labels[:n])
            except (IOError, ValueError) as e:
                log.warning("LFW download/read failed (%r); falling back", e)
        try:
            from sklearn.datasets import fetch_lfw_people

            lfw = fetch_lfw_people(min_faces_per_person=20,
                                   download_if_missing=False)
            X = lfw.images.astype(np.float32) / 255.0
            y = lfw.target
        except Exception:  # noqa: BLE001 — no cache, or no scikit-learn
            rng = np.random.RandomState(7)
            centers = rng.rand(self.n_classes, 62 * 47).astype(np.float32)
            y = rng.randint(0, self.n_classes, size=num_examples)
            X = centers[y] + 0.1 * rng.randn(
                num_examples, 62 * 47).astype(np.float32)
            X = X.reshape(-1, 62, 47)
        n = min(num_examples, len(X))
        k = int(y.max()) + 1
        return DataSet(X[:n].reshape(n, -1), labels_to_one_hot(y[:n], k))


class Cifar10DataFetcher(BaseDataFetcher):
    """CIFAR-10 (BASELINE configs[2]): real batches when a local copy or a
    configured source exists, deterministic synthetic stand-in otherwise.
    The reference has no CIFAR fetcher at all — this exceeds it."""

    def __init__(self, train: bool = True):
        self.train = train

    def fetch(self, num_examples: int = 50000) -> DataSet:
        from deeplearning4j_tpu_torch.datasets import cifar

        X = None
        try:
            d = cifar.find_cifar10_dir()
            if d is None and os.environ.get("DL4J_CIFAR10_URL"):
                from deeplearning4j_tpu_torch.datasets.fetch import \
                    fetch_cifar10

                d = fetch_cifar10()
            if d is not None:
                X, y = cifar.load_real_cifar10(d, self.train, num_examples)
        except Exception as e:  # noqa: BLE001 — corrupt archive/pickle/...
            # tarfile.ReadError, pickle errors etc. are NOT IOErrors; any
            # acquisition failure must land on the synthetic path, not
            # crash the caller
            log.warning("CIFAR-10 acquisition failed (%r); using synthetic",
                        e)
        if X is None:
            X, y = cifar.synthetic_cifar10(num_examples)
        return DataSet(X, labels_to_one_hot(y, 10))


class CurvesDataFetcher(BaseDataFetcher):
    """Curves corpus: real .npz when $CURVES_DIR holds one (or
    $DL4J_CURVES_URL is configured — `fetch.fetch_curves`, the analog of
    CurvesDataFetcher.java:38-65's S3 download); otherwise synthetic smooth
    random 1-d curves rasterized to 784 features, autoencoder-style
    (labels == features)."""

    def fetch(self, num_examples: int = 1000) -> DataSet:
        real = self._fetch_real(num_examples)
        if real is not None:
            return real
        rng = np.random.RandomState(42)
        t = np.linspace(0, 1, 784, dtype=np.float32)
        freqs = rng.rand(num_examples, 3) * 8
        phases = rng.rand(num_examples, 3) * 2 * np.pi
        amps = rng.rand(num_examples, 3)
        X = np.zeros((num_examples, 784), np.float32)
        for i in range(3):
            X += amps[:, i:i + 1] * np.sin(
                2 * np.pi * freqs[:, i:i + 1] * t + phases[:, i:i + 1])
        X = (X - X.min()) / (X.max() - X.min() + 1e-6)
        return DataSet(X, X.copy())

    def _fetch_real(self, num_examples: int) -> Optional[DataSet]:
        """Locate (or download) a curves .npz; None -> synthetic path."""
        path = None
        d = os.environ.get("CURVES_DIR")
        if d and os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.endswith(".npz"):
                    path = os.path.join(d, name)
                    break
        if path is None and os.environ.get("DL4J_CURVES_URL"):
            from deeplearning4j_tpu_torch.datasets.fetch import fetch_curves

            try:
                path = fetch_curves()
            except IOError as e:
                log.warning("curves download failed (%r); using synthetic", e)
        if path is None:
            return None
        with np.load(path) as z:
            X = np.asarray(z["features"], np.float32)[:num_examples]
            y = (np.asarray(z["labels"], np.float32)[:num_examples]
                 if "labels" in z else X.copy())
        return DataSet(X, y)


class CSVDataFetcher(BaseDataFetcher):
    """CSV -> DataSet with a label column."""

    def __init__(self, path: str, label_column: int = -1,
                 skip_header: bool = False,
                 n_classes: Optional[int] = None):
        self.path = path
        self.label_column = label_column
        self.skip_header = skip_header
        self.n_classes = n_classes

    def fetch(self, num_examples: int = int(1e9)) -> DataSet:
        from deeplearning4j_tpu_torch.native import native_read_csv
        arr = native_read_csv(self.path, skip_header=self.skip_header)
        if arr is not None:
            arr = arr[:num_examples].astype(np.float32)
            return self._to_dataset(arr)
        rows = []
        with open(self.path, newline="") as f:
            reader = csv_mod.reader(f)
            for i, row in enumerate(reader):
                if self.skip_header and i == 0:
                    continue
                if not row:
                    continue
                rows.append([float(v) for v in row])
                if len(rows) >= num_examples:
                    break
        return self._to_dataset(np.asarray(rows, np.float32))

    def _to_dataset(self, arr: np.ndarray) -> DataSet:
        lc = self.label_column % arr.shape[1]
        y = arr[:, lc].astype(np.int64)
        X = np.delete(arr, lc, axis=1)
        k = self.n_classes or int(y.max()) + 1
        return DataSet(X, labels_to_one_hot(y, k))


# -- convenience iterators (datasets/iterator/impl parity) -----------------

def iris_iterator(batch_size: int = 10, num_examples: int = 150,
                  shuffle_seed: int = 123) -> DataSetIterator:
    # iris ships class-sorted; unshuffled minibatches would be single-class
    data = IrisDataFetcher().fetch(num_examples).shuffle(shuffle_seed)
    return ListDataSetIterator(data, batch_size)


def mnist_iterator(batch_size: int = 10, num_examples: int = 1000,
                   binarize: bool = True,
                   train: bool = True) -> DataSetIterator:
    data = MnistDataFetcher(binarize, train).fetch(num_examples)
    return ListDataSetIterator(data, batch_size)


def lfw_iterator(batch_size: int = 10,
                 num_examples: int = 300) -> DataSetIterator:
    return ListDataSetIterator(LFWDataFetcher().fetch(num_examples),
                               batch_size)


def curves_iterator(batch_size: int = 10,
                    num_examples: int = 300) -> DataSetIterator:
    return ListDataSetIterator(CurvesDataFetcher().fetch(num_examples),
                               batch_size)


def cifar10_iterator(batch_size: int = 10, num_examples: int = 1000,
                     train: bool = True) -> DataSetIterator:
    return ListDataSetIterator(
        Cifar10DataFetcher(train).fetch(num_examples), batch_size)
