"""Batch iterators and the host-to-device prefetcher.

Counterpart of `deeplearning4j_tpu/datasets/iterator.py` (its own copy):
`DataSetIterator`, `ListDataSetIterator`, `SamplingDataSetIterator`,
`MultipleEpochsIterator`, `ReconstructionDataSetIterator`,
`moving_window_dataset` with `MovingWindowBaseDataSetIterator`,
`TestDataSetIterator`, and `PrefetchIterator`, which moves batches to the
device ahead of the consumer. Every iterator but the prefetcher is host
numpy; a selection of examples takes each example's label rows
(`DataSet.get`).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nd.platform import resolve_device
from deeplearning4j_tpu_torch.reliability import faults


class DataSetIterator:
    """Abstract batch iterator over a dataset."""

    def __init__(self, batch_size: int, total_examples: int):
        self.batch_size = batch_size
        self._total = total_examples
        self.cursor = 0

    def total_examples(self) -> int:
        return self._total

    def batch(self) -> int:
        return self.batch_size

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        self.cursor = 0

    def has_next(self) -> bool:
        return self.cursor < self._total

    def next(self, num: Optional[int] = None) -> DataSet:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()


class ListDataSetIterator(DataSetIterator):
    """Batches over an in-memory DataSet."""

    def __init__(self, data: DataSet, batch_size: int = 10):
        super().__init__(batch_size, data.num_examples())
        self.data = data

    def input_columns(self) -> int:
        return self.data.num_inputs()

    def total_outcomes(self) -> int:
        return self.data.num_outcomes()

    def next(self, num: Optional[int] = None) -> DataSet:
        # num=0 is an empty batch, not the default size
        n = self.batch_size if num is None else num
        out = self.data.get(slice(self.cursor, self.cursor + n))
        # advance by the rows served: a ragged last batch counts its own
        self.cursor += out.num_examples()
        return out


class SamplingDataSetIterator(DataSetIterator):
    """Batches drawn at random with replacement, `total_batches` of them,
    by `RandomState(seed).choice` as the JAX package draws them."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: int = 123):
        super().__init__(batch_size, total_batches * batch_size)
        self.data = data
        self._rng = np.random.RandomState(seed)

    def input_columns(self) -> int:
        return self.data.num_inputs()

    def total_outcomes(self) -> int:
        return self.data.num_outcomes()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = self.batch_size if num is None else num
        idx = self._rng.choice(self.data.num_examples(), size=n)
        self.cursor += n
        return self.data.get(idx)


class MultipleEpochsIterator(DataSetIterator):
    """Replays an underlying iterator for `epochs` epochs."""

    def __init__(self, epochs: int, base: DataSetIterator):
        super().__init__(base.batch_size, base.total_examples() * epochs)
        self.epochs = epochs
        self.base = base
        self._epoch = 0

    def input_columns(self) -> int:
        return self.base.input_columns()

    def total_outcomes(self) -> int:
        return self.base.total_outcomes()

    def reset(self) -> None:
        super().reset()
        self._epoch = 0
        self.base.reset()

    def has_next(self) -> bool:
        if self.base.has_next():
            return self._epoch < self.epochs
        return self._epoch + 1 < self.epochs

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.base.has_next():
            self.base.reset()
            self._epoch += 1
        out = self.base.next(num)
        self.cursor += out.num_examples()
        return out


class ReconstructionDataSetIterator(DataSetIterator):
    """Each batch of `base` with its features as its labels (a copy): the
    stream an autoencoder or RBM trains on."""

    def __init__(self, base: DataSetIterator):
        super().__init__(base.batch_size, base.total_examples())
        self.base = base

    def input_columns(self) -> int:
        return self.base.input_columns()

    def total_outcomes(self) -> int:
        # the target is the features themselves
        return self.base.input_columns()

    def reset(self) -> None:
        super().reset()
        self.base.reset()

    def has_next(self) -> bool:
        return self.base.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        d = self.base.next(num)
        self.cursor = self.base.cursor
        return DataSet(d.features, np.array(d.features, copy=True))


def moving_window_dataset(data: DataSet, window_rows: int,
                          window_cols: int, rotate: bool = True) -> DataSet:
    """Every square image of `data` (features [n, side*side]) cut into all
    its non-overlapping window_rows x window_cols tiles, and, for square
    windows with `rotate`, the tiles turned by 90, 180 and 270 degrees
    (`np.rot90` k = 1, 2, 3, after the unturned tiles); each row one
    window, labelled with its image's label. Rows come image by image, in
    the JAX package's order."""
    n, d = data.features.shape
    side = int(round(d ** 0.5))
    if side * side != d:
        raise ValueError(f"features ({d} columns) are not square images")
    if side % window_rows or side % window_cols:
        raise ValueError(f"{side}x{side} images do not tile into "
                         f"{window_rows}x{window_cols} windows")
    imgs = data.features.reshape(n, side // window_rows, window_rows,
                                 side // window_cols, window_cols)
    tiles = imgs.transpose(0, 1, 3, 2, 4).reshape(
        n, -1, window_rows, window_cols)  # [n, tiles, wr, wc]
    variants = [tiles]
    if rotate and window_rows == window_cols:
        for k in (1, 2, 3):
            variants.append(np.rot90(tiles, k=k, axes=(2, 3)))
    stacked = np.concatenate(variants, axis=1)  # [n, v*tiles, wr, wc]
    per_img = stacked.shape[1]
    feats = np.ascontiguousarray(stacked).reshape(
        n * per_img, window_rows * window_cols)
    labels = np.repeat(data.labels, per_img, axis=0)
    return DataSet(feats.astype(np.float32), labels)


class MovingWindowBaseDataSetIterator(ListDataSetIterator):
    """Batches over `moving_window_dataset(data, ...)`."""

    def __init__(self, data: DataSet, window_rows: int, window_cols: int,
                 batch_size: int = 10, rotate: bool = True):
        super().__init__(
            moving_window_dataset(data, window_rows, window_cols, rotate),
            batch_size)


class TestDataSetIterator(DataSetIterator):
    """Wraps any iterator and keeps every batch it served (`served`)."""

    def __init__(self, base: DataSetIterator):
        super().__init__(base.batch_size, base.total_examples())
        self.base = base
        self.served: List[DataSet] = []

    def input_columns(self) -> int:
        return self.base.input_columns()

    def total_outcomes(self) -> int:
        return self.base.total_outcomes()

    def reset(self) -> None:
        super().reset()
        self.base.reset()

    def has_next(self) -> bool:
        return self.base.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        d = self.base.next(num)
        self.served.append(d)
        self.cursor = self.base.cursor
        return d


class DeviceBatch(NamedTuple):
    """A (features, labels) pair of tensors already on (or on their way to)
    the device; every consumer of a DataSet's two fields takes it."""

    features: torch.Tensor
    labels: torch.Tensor

    def num_examples(self) -> int:
        return int(self.features.shape[0])


#: batches a PrefetchIterator keeps in flight beyond the one being consumed
PREFETCH_DEPTH = 2


class PrefetchIterator:
    """Batches moved to the device ahead of the consumer.

    Wraps any iterable of batches (a `DataSetIterator`, a list of
    `DataSet`s, (features, labels) tuples or arrays) and keeps up to
    `buffer_batches` batches in flight beyond the one the consumer holds
    (None: the "data.prefetch_depth" tunable, registry default
    PREFETCH_DEPTH).
    A DataSet becomes a `DeviceBatch`, a tuple a tuple of tensors, an array
    a tensor; float64 becomes float32, as the JAX package's transfer gives.
    With `to_device=False` the base's items are handed over as they are.

    On a CUDA device each array is staged in pinned host memory and copied
    with `non_blocking=True` on a side stream, and an event is recorded
    after the copies; the consumer's stream waits on that event when the
    batch is handed over, so the copy of the next batches overlaps the
    device work on this one. On the CPU it is a plain lookahead. Iterating
    stages in the consumer's thread (the JAX package uses a worker thread
    for its device_put; here the copy engine gives the overlap).

    `start()`, `pull()` and `close()` are the JAX package's multi-consumer
    form. A worker thread reads the base into a queue of `buffer_batches`
    (firing `prefetch.worker` once a batch); any number of consumer threads
    call `pull()`, and each batch goes to exactly one of them, staged as
    above by the consumer that takes it from the queue (the worker makes
    no CUDA call, so a consumer may capture a CUDA graph meanwhile).
    `pull()` raises StopIteration at the end of the stream, for every
    consumer, and after `close()`, which any thread may call and which
    releases a consumer waiting for a batch; a worker error is raised at
    exactly one consumer and ends the others' pulls.

    `device=None` is CUDA and raises without a GPU, as every entry point of
    the port does. Iterating again restarts from the base (its `reset()`
    first, where it has one)."""

    _ITEM = "item"
    _DONE = "done"
    _ERROR = "error"
    #: seconds a waiting consumer or worker sleeps between looks at the
    #: stop flag
    _WAIT_S = 0.05

    def __init__(self, base, device=None,
                 buffer_batches: Optional[int] = None,
                 to_device: bool = True):
        from deeplearning4j_tpu_torch.optimize import tunables

        self.base = base
        if buffer_batches is None:
            buffer_batches = tunables.resolve("data.prefetch_depth")
        self.buffer_batches = max(1, int(buffer_batches))
        self.to_device = bool(to_device)
        self.device = resolve_device(device) if self.to_device else None
        self._stream: Optional[torch.cuda.Stream] = None
        # the multi-consumer pipeline (`start`, `pull`, `close`)
        self._lock = threading.Lock()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pending: collections.deque = collections.deque()
        self._end: Optional[tuple] = None

    def _tensor(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if t.dtype == torch.float64:
            t = t.float()
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _convert(self, item):
        if hasattr(item, "features") and hasattr(item, "labels"):
            return DeviceBatch(self._tensor(item.features),
                               self._tensor(item.labels))
        if isinstance(item, tuple):
            return tuple(self._tensor(a) for a in item)
        return self._tensor(item)

    def _stage(self, item):
        """Start one batch's copy: (the batch, its copy event or None)."""
        if not self.to_device:
            return item, None
        if self.device.type != "cuda":
            return self._convert(item), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = self._convert(item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _hand_over(self, out, event):
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # made on the side stream, used on this one: the allocator must
            # not reuse the memory before this stream is done with it
            for t in (out if isinstance(out, tuple) else (out,)):
                t.record_stream(stream)
        return out

    def __iter__(self):
        if hasattr(self.base, "reset"):
            self.base.reset()
        pending = collections.deque()
        for item in self.base:
            # an armed fault stands for a worker that dies mid-epoch, as
            # at the JAX package's prefetch worker
            faults.fire("prefetch.worker")
            pending.append(self._stage(item))
            if len(pending) > self.buffer_batches:
                yield self._hand_over(*pending.popleft())
        while pending:
            yield self._hand_over(*pending.popleft())

    # -- the multi-consumer pipeline -----------------------------------------
    def _put(self, q: queue.Queue, stop: threading.Event, msg) -> bool:
        """Queue `msg`, waiting in slices so that a stopped pipeline
        releases the worker instead of leaving it on a full queue."""
        while not stop.is_set():
            try:
                q.put(msg, timeout=self._WAIT_S)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, q: queue.Queue, stop: threading.Event) -> None:
        try:
            for item in self.base:
                if stop.is_set():
                    return
                faults.fire("prefetch.worker")
                if not self._put(q, stop, (self._ITEM, item)):
                    return
            self._put(q, stop, (self._DONE, None))
        except BaseException as e:  # noqa: BLE001 — raised at one consumer
            self._put(q, stop, (self._ERROR, e))

    def _start_locked(self) -> None:
        self.close()
        if hasattr(self.base, "reset"):
            self.base.reset()
        self._stop = threading.Event()
        self._pending = collections.deque()
        self._end = None
        self._queue = queue.Queue(maxsize=self.buffer_batches)
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop),
            name="dl4j-torch-prefetch", daemon=True)
        self._thread.start()

    def start(self) -> None:
        """(Re)start the pipeline from the base. The first `pull()` starts
        it where nothing has; after `close()`, only `start()` or `reset()`
        does."""
        with self._lock:
            self._start_locked()

    def _take(self, q: queue.Queue, stop: threading.Event):
        """Under the lock: the next staged batch (batch, event), or None
        when the worker has none ready yet. Stages what the queue holds,
        up to `buffer_batches` beyond the one taken; at the end of the
        stream raises StopIteration, or the worker's error once."""
        wait = not self._pending
        while self._end is None and len(self._pending) <= self.buffer_batches:
            try:
                kind, payload = (q.get(timeout=self._WAIT_S) if wait
                                 else q.get_nowait())
            except queue.Empty:
                break
            wait = False
            if kind == self._ITEM:
                self._pending.append(self._stage(payload))
            else:
                self._end = (kind, payload)
        if self._pending:
            return self._pending.popleft()
        if self._end is None:
            return None
        kind, payload = self._end
        if kind == self._ERROR:
            # raised here once; the other consumers stop
            self._end = (self._DONE, None)
            stop.set()
            raise payload
        raise StopIteration

    def pull(self):
        """The next batch; thread-safe. Any number of consumer threads may
        pull from one running pipeline, and each batch goes to exactly one
        of them. Raises StopIteration at the end of the stream and after
        `close()` (a consumer waiting then stops too); a worker error is
        raised at exactly one consumer, and the others then stop."""
        with self._lock:
            if self._queue is None:
                if self._stop.is_set():
                    raise StopIteration  # closed: `start()` runs it again
                self._start_locked()
            q, stop = self._queue, self._stop
        while not stop.is_set():
            # a timed wait for the lock, so that `close()` releases a
            # consumer queued behind another
            if not self._lock.acquire(timeout=self._WAIT_S):
                continue
            try:
                if stop.is_set():
                    break
                out = self._take(q, stop)
            finally:
                self._lock.release()
            if out is not None:
                return self._hand_over(*out)
        raise StopIteration

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop the pipeline's worker and join it (idempotent; any thread
        may call it, a consumer waiting in `pull()` then stops). A worker
        stuck inside the base is left behind as a daemon thread: the stop
        flag ends it when its call returns."""
        self._stop.set()
        thread, self._thread = self._thread, None
        q, self._queue = self._queue, None
        if thread is None:
            return
        deadline = time.monotonic() + join_timeout
        while thread.is_alive() and time.monotonic() < deadline:
            # drain, so that a worker waiting on a full queue sees the flag
            if q is not None:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
            thread.join(timeout=self._WAIT_S)

    def reset(self) -> None:
        """DataSetIterator-style reset: the pipeline stops; iterating or
        `pull()` starts again from the base."""
        self.close()
        with self._lock:
            self._stop = threading.Event()
