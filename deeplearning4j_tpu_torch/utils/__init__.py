"""Shared utilities: the port's copies of the JAX package's `utils/`
modules (the Berkeley-style collections, the disk-backed queue, object
serialization, archives, math, string grids, time series and the thread
pool helpers), the device Viterbi decoder and the profiling helpers."""

from deeplearning4j_tpu_torch.utils.collections import (
    Counter, CounterMap, Index, MultiDimensionalMap)
from deeplearning4j_tpu_torch.utils.disk_queue import DiskBasedQueue
from deeplearning4j_tpu_torch.utils.serialization import (
    load_object, save_object)
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = [
    "Counter", "CounterMap", "Index", "MultiDimensionalMap",
    "DiskBasedQueue", "load_object", "save_object", "Viterbi",
]
