"""Record readers, the record -> DataSet bridge, and image loading.

Counterpart of `deeplearning4j_tpu/datasets/records.py` (its own copy):
`ImageLoader` (an image file as a matrix or a row; PIL is imported only
when an image is read), `CSVRecordReader` and `ImageRecordReader` (an
image-folder tree, the label from the subdirectory name), and
`RecordReaderDataSetIterator`, which turns any reader into DataSet batches
on the port's `DataSetIterator` contract; `image_folder_dataset` is the
one-call image folder -> DataSet.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (DataSet,
                                                       labels_to_one_hot)
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm",
                    ".gif", ".tif", ".tiff")


class ImageLoader:
    """Image file -> float array (`util/ImageLoader.java` parity).

    PIL-backed; `as_matrix` returns HxW (grayscale) or HxWxC, `as_row`
    flattens — the two shapes the reference's loader produced."""

    def __init__(self, height: Optional[int] = None,
                 width: Optional[int] = None, grayscale: bool = True,
                 normalize: bool = True):
        self.height = height
        self.width = width
        self.grayscale = grayscale
        self.normalize = normalize

    def as_matrix(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            if self.grayscale:
                im = im.convert("L")
            elif im.mode != "RGB":
                im = im.convert("RGB")
            if self.height and self.width:
                im = im.resize((self.width, self.height))
            arr = np.asarray(im, dtype=np.float32)
        if self.normalize:
            arr = arr / 255.0
        return arr

    def as_row(self, path: str) -> np.ndarray:
        return self.as_matrix(path).reshape(-1)


class RecordReader:
    """A record source: iterates (features_row, label_index) pairs.

    The Canova `RecordReader` contract reduced to what the DataSet bridge
    needs; `reset()` makes readers reusable across epochs."""

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[int]]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    @property
    def labels(self) -> List[str]:
        raise NotImplementedError


class CSVRecordReader(RecordReader):
    """CSV rows -> records (`CSVRecordReader` via the Canova bridge)."""

    def __init__(self, path: str, label_column: Optional[int] = -1,
                 skip_header: bool = False):
        self.path = path
        self.label_column = label_column
        self.skip_header = skip_header
        self._labels: List[str] = []

    def __iter__(self):
        import csv

        with open(self.path, newline="") as f:
            reader = csv.reader(f)
            for i, row in enumerate(reader):
                if (self.skip_header and i == 0) or not row:
                    continue
                vals = [float(v) for v in row]
                if self.label_column is None:
                    yield np.asarray(vals, np.float32), None
                else:
                    lc = self.label_column % len(vals)
                    label = int(vals[lc])
                    del vals[lc]
                    yield np.asarray(vals, np.float32), label

    @property
    def num_classes(self) -> int:
        return 1 + max(label for _, label in self if label is not None)

    @property
    def labels(self) -> List[str]:
        return [str(i) for i in range(self.num_classes)]


class ImageRecordReader(RecordReader):
    """Image-folder tree -> records: `root/<label>/<image>` with the label
    taken from the subdirectory name (the standard image-dataset layout;
    ref `ImageVectorizer` + Canova image readers)."""

    def __init__(self, root: str, height: int, width: int,
                 grayscale: bool = True, normalize: bool = True,
                 extensions: Sequence[str] = IMAGE_EXTENSIONS):
        self.root = root
        self.loader = ImageLoader(height, width, grayscale, normalize)
        self.extensions = tuple(e.lower() for e in extensions)
        self._labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self._labels:
            raise ValueError(f"no class subdirectories under {root}")
        self._files: List[Tuple[str, int]] = []
        for li, label in enumerate(self._labels):
            ldir = os.path.join(root, label)
            for fn in sorted(os.listdir(ldir)):
                if fn.lower().endswith(self.extensions):
                    self._files.append((os.path.join(ldir, fn), li))

    def __iter__(self):
        for path, label in self._files:
            yield self.loader.as_row(path), label

    def __len__(self) -> int:
        return len(self._files)

    @property
    def num_classes(self) -> int:
        return len(self._labels)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)


class RecordReaderDataSetIterator(DataSetIterator):
    """Any RecordReader -> DataSet minibatches: one-hot labels (or the
    label index as a float column with `one_hot=False`), the features
    themselves as the target of a reader without labels, and an optional
    seeded shuffle of the records."""

    def __init__(self, reader: RecordReader, batch_size: int = 32,
                 num_classes: Optional[int] = None,
                 one_hot: bool = True, shuffle_seed: Optional[int] = None):
        self.reader = reader
        self.one_hot = one_hot
        self.shuffle_seed = shuffle_seed
        records = list(reader)
        feats = np.stack([f for f, _ in records])
        has_labels = records and records[0][1] is not None
        if has_labels:
            raw = np.asarray([lb for _, lb in records], np.int64)
            k = num_classes or getattr(reader, "num_classes", None) \
                or int(raw.max()) + 1
            labels = labels_to_one_hot(raw, k) if one_hot \
                else raw.astype(np.float32)[:, None]
        else:
            labels = feats.copy()  # unsupervised: the reconstruction target
        if shuffle_seed is not None:
            order = np.random.RandomState(shuffle_seed).permutation(
                len(feats))
            feats, labels = feats[order], labels[order]
        self._data = DataSet(feats, labels)
        super().__init__(batch_size, len(self._data))

    def input_columns(self) -> int:
        return self._data.num_inputs()

    def total_outcomes(self) -> int:
        return self._data.num_outcomes()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = self.batch_size if num is None else num
        end = min(self.cursor + n, len(self._data))
        ds = self._data.get(slice(self.cursor, end))
        self.cursor = end
        return ds


def image_folder_dataset(root: str, height: int, width: int,
                         grayscale: bool = True) -> DataSet:
    """One-call image-folder -> DataSet (ImageVectorizer parity)."""
    reader = ImageRecordReader(root, height, width, grayscale)
    it = RecordReaderDataSetIterator(reader, batch_size=len(reader))
    return next(iter(it))
